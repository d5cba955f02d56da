"""Import torch checkpoints (counterpart of cspn_tpu/models/torch_import.py):
torchvision-format pretrained ResNet weights into the encoder
(`load_torch_encoder_params`; reference torch_resnet_cspn_nyu.py:403-413 +
update_model.py:13-31), and whole models trained by the reference
(`load_torch_cspn_checkpoint`, below).

The port's encoder keeps torchvision's names, so the mapping is short:

    module.*                     -> *           (DataParallel prefix)
    conv1.weight                 -> conv1_1.weight (3 channels: skipped by
                                    partial_restore on shape against the
                                    4-channel RGBD stem, as in the reference)
    bn1.*, layer{s}.{b}.*        -> the same names
    fc.*                         -> dropped
    *.num_batches_tracked        -> dropped (the JAX package keeps no counter)

Merge the result with `train.state.partial_restore`, which copies only
names and shapes that match; the decoder and head keep their init.

A full reference checkpoint (best_model.pth / epoch_NN.pth, reference
train.py:229-231,277-280) needs no renaming either: CSPNUNet keeps every
module name of the reference's `ResNet` (torch_resnet_cspn_nyu.py:278-319),
and both decoder forms hold the same 5x5 and 3x3 weights under the same
keys (models/decoder.py).  `convert_cspn_state_dict` strips the
DataParallel prefix and drops what the reference builds but its forward
never calls, as the JAX package's `_SKIP_PREFIXES` (torch_import.py:104):
`up_proj_layer*`, `post_process_layer*` (the CSPN's frozen all-ones sum
conv), `conv3.`, `fc.`, and the BN counters.
"""

from __future__ import annotations

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def convert_resnet_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """A torchvision ResNet state dict in the port's encoder names (f32)."""
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        if not (key.startswith(("conv1.", "bn1.", "layer")) and key.rsplit(".", 1)[-1] in _BN_LEAVES):
            continue
        out["conv1_1.weight" if key == "conv1.weight" else key] = value.float()
    return out


def load_torch_encoder_params(path: str) -> dict[str, torch.Tensor]:
    """Load a torch .pth checkpoint on the CPU and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_resnet_state_dict(sd)


_SKIP_PREFIXES = ("up_proj_layer", "post_process_layer", "conv3.", "fc.")


def convert_cspn_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """A reference model's full state dict in CSPNUNet's names (f32)."""
    out = {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if key.endswith("num_batches_tracked") or key.startswith(_SKIP_PREFIXES):
            continue
        out[key] = value.float()
    return out


def load_torch_cspn_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Load a reference-trained checkpoint on the CPU and convert the
    whole model; merge it with `train.state.partial_restore`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_cspn_state_dict(sd)
