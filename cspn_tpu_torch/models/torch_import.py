"""Import torchvision-format pretrained ResNet weights into the encoder
(counterpart of cspn_tpu/models/torch_import.py:load_torch_encoder_params;
reference torch_resnet_cspn_nyu.py:403-413 + update_model.py:13-31).

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
