"""Linear resizes (counterpart of cspn_tpu/ops/resize.py).

`jax.image.resize(method='linear')` samples at half-pixel centers and, when
it upsamples, is `F.interpolate(mode='bilinear'|'trilinear',
align_corners=False)`: both place output i at input (i + 0.5) * in/out - 0.5
and give a position outside the input the nearest edge value.  JAX
antialiases when it downsamples and PyTorch's trilinear cannot, so a size
below the input's raises here; the stereo model only upsamples.

Signatures keep the JAX package's channels-last layout; `channel_first=True`
takes and returns PyTorch's [N, C, *spatial] instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

_MODES = {2: "bilinear", 3: "trilinear"}


def _resize(x: torch.Tensor, out: Sequence[int], channel_first: bool) -> torch.Tensor:
    ndim = len(out)
    x_cf = x if channel_first else x.movedim(-1, 1)
    if x_cf.ndim != ndim + 2:
        raise ValueError(f"expected a {ndim + 2}-d input for a {ndim}-d size, got {tuple(x.shape)}")
    if any(o < i for o, i in zip(out, x_cf.shape[2:])):
        raise ValueError(f"downsampling {tuple(x_cf.shape[2:])} -> {tuple(out)} is not supported "
                         "(jax.image.resize antialiases there)")
    y = F.interpolate(x_cf, size=tuple(out), mode=_MODES[ndim], align_corners=False)
    return y if channel_first else y.movedim(1, -1)


def resize_bilinear(x: torch.Tensor, out_hw: Sequence[int], *, channel_first: bool = False):
    """x: [N, H, W, C] -> [N, out_h, out_w, C] (or [N, C, H, W] -> [N, C, out_h, out_w])."""
    return _resize(x, out_hw, channel_first)


def resize_trilinear(x: torch.Tensor, out_dhw: Sequence[int], *, channel_first: bool = False):
    """x: [N, D, H, W, C] -> [N, *out_dhw, C] (or [N, C, D, H, W] -> [N, C, *out_dhw])."""
    return _resize(x, out_dhw, channel_first)
