"""JAX package parameters -> the port's state dict (the inverse of
cspn_tpu/models/torch_import.py's mapping).

Takes `{'params': ..., 'batch_stats': ...}` of `cspn_tpu`'s CSPNUNet or
PSMNetCSPN as nested dicts of numpy arrays (what
`jax.tree.map(np.asarray, variables)` gives) and returns a state dict for
`cspn_tpu_torch.models.CSPNUNet` or `models.stereo.PSMNetCSPN`:

    encoder/<m>/...                -> <m>...        (encoder at top level)
    layer{s}_{b}                   -> layer{s}.{b}
    ds_conv / ds_bn                -> downsample.0 / downsample.1
    <bn>/BatchNorm_0/scale, bias   -> <bn>.weight, <bn>.bias
    batch_stats <bn>/BatchNorm_0/mean, var -> <bn>.running_mean, running_var
    <conv>/kernel (HWIO)           -> <conv>.weight (OIHW, transpose (3,2,0,1))
    <conv3d>/kernel (kd,kh,kw,I,O) -> <conv3d>.weight (O,I,kd,kh,kw)
    Conv_0 (an unnamed flax conv)  -> conv

The fused head's `gud_up_proj_layer5/conv1/kernel` (1 out) and
`gud_up_proj_layer6/conv1/kernel` (8 out) keep their own names.  An
unmapped or missing key, or a shape mismatch, raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_STAGE_BLOCK = re.compile(r"layer(\d)_(\d+)")
_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def port_key(collection: str, path: tuple[str, ...]) -> str:
    """State-dict key of the JAX leaf `collection/path`."""
    *mods, leaf = path
    if (collection, leaf) not in _LEAF:
        raise KeyError(f"unmapped JAX leaf {collection}/{'/'.join(path)}")
    if mods and mods[0] == "encoder":
        mods = mods[1:]
    out: list[str] = []
    for m in mods:
        stage = _STAGE_BLOCK.fullmatch(m)
        if stage:
            out += [f"layer{stage.group(1)}", stage.group(2)]
        elif m in ("ds_conv", "ds_bn"):
            out += ["downsample", "0" if m == "ds_conv" else "1"]
        elif m == "Conv_0":
            out.append("conv")
        elif m != "BatchNorm_0":
            out.append(m)
    return ".".join(out + [_LEAF[(collection, leaf)]])


def convert_jax_tree(collection: str, tree: Mapping) -> dict[str, np.ndarray]:
    """A JAX tree of the `collection` ('params' or 'batch_stats') layout --
    the variables themselves, or a gradient tree of the params -- as port
    state-dict keys, with conv kernels in OIHW (3D: O, I, kd, kh, kw)."""
    out = {}
    for path, arr in _flatten(tree):
        if arr.ndim >= 4:  # HWIO / DHWIO -> OIHW / OIDHW
            arr = arr.transpose(arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2))
        out[port_key(collection, path)] = arr
    return out


def convert_jax_variables(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """Map JAX `variables` onto `model`'s state dict; raises on any key the
    mapping does not place, any model key it leaves unset (BN
    `num_batches_tracked` counters excepted: torch-only, kept), and any
    shape mismatch."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unmapped JAX collections {sorted(unknown)}")
    target = model.state_dict()
    sd: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for key, arr in convert_jax_tree(collection, variables.get(collection, {})).items():
            if key not in target:
                raise KeyError(f"JAX leaf of {collection} maps to {key!r}, "
                               "which the model does not have")
            if tuple(arr.shape) != tuple(target[key].shape):
                raise ValueError(f"{key}: JAX shape {arr.shape} != model shape "
                                 f"{tuple(target[key].shape)}")
            sd[key] = torch.from_numpy(np.array(arr, order="C")).to(target[key].dtype)
    missing = [k for k in target if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"model keys without a JAX leaf: {missing[:8]} ({len(missing)} in all)")
    for k in target:
        sd.setdefault(k, target[k].clone())
    return sd


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load converted JAX `variables` into `model` in place; returns it."""
    model.load_state_dict(convert_jax_variables(variables, model), strict=True)
    return model
