"""Gudi up-projection decoder blocks (counterpart of cspn_tpu/models/decoder.py).

NCHW PyTorch form of the decoder half of
cspn_pytorch/models/torch_resnet_cspn_nyu.py.  Each block upsamples with a
`zero-insert unpool -> crop -> k x k conv` pair, in one of two forms that
compute the same function, as in the JAX package:

  - subpixel (`subpixel=True`, the default): `SubpixelUnpoolConv`, one
    half-resolution conv into four phase groups followed by
    ops/d2s.py:depth_to_space2 (the CUDA `d2s` kernel on the card);
  - plain (`subpixel=False`): `unpool2x`, then the k x k conv -- the
    reference model's own form, which JAX keeps as the translation baseline.

The weight is the same `nn.Conv2d` parameter in both forms (OIHW, at the
same state-dict key), so one checkpoint loads into either.

  - `UpProj`         <- UpProj_Block (:126-160), plain only, as in JAX
  - `GudiUpProj`     <- Gudi_UpProj_Block (:208-240)
  - `GudiUpProjCat`  <- Gudi_UpProj_Block_Cat (:243-276), concatenates a skip
    map after the first conv (:270)
  - `GudiUpConv`     <- Simple_Gudi_UpConv_Block (:162-185)
  - `GudiUpConvLast` <- Simple_Gudi_UpConv_Block_Last_Layer (:187-206), raw
    head output (no BN/ReLU)

Blocks crop the 2x-unpooled map to (oheight, owidth), which the model
derives from the input shape and passes to forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cspn_tpu_torch.models.resnet import conv
from cspn_tpu_torch.ops.d2s import depth_to_space2


def unpool2x(x: torch.Tensor, oheight: int, owidth: int) -> torch.Tensor:
    """Zero-insert 2x upsample (value at top-left of each 2x2 cell), then
    crop to (oheight, owidth).  x: [N, C, H, W]."""
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, 2 * h, 2 * w))
    out[:, :, ::2, ::2] = x
    return out[:, :, :oheight, :owidth]


def _phase_taps(k: int, p: int) -> tuple[list[int], tuple[int, int]]:
    """Valid source offsets s (with dy = 2s - p, |dy| <= k//2) for one
    output phase p of the zero-insert-unpool + kxk conv, and the explicit
    conv padding (lo, hi) that realizes out[y] = sum_s in[y+s] K[s].
    The valid offsets are contiguous: k=5 -> {-1,0,1} / {0,1};
    k=3 -> {0} / {0,1}."""
    kh = k // 2
    s_lo = -1 if k >= 5 else 0
    ss = [s for s in range(s_lo, s_lo + kh + 2) if abs(2 * s - p) <= kh]
    return ss, (-ss[0], ss[-1])


def _phase_kernel(w: torch.Tensor, k: int, px: int, py: int) -> torch.Tensor:
    """Exact (zero-free) OIHW kernel of one output phase: the rows
    2s - py + k//2 and columns 2t - px + k//2 of the valid taps, a stride-2
    slice of `w`."""
    kh = k // 2
    ss, _ = _phase_taps(k, py)
    ts, _ = _phase_taps(k, px)
    r0, c0 = 2 * ss[0] - py + kh, 2 * ts[0] - px + kh
    return w[:, :, r0 : r0 + 2 * len(ss) - 1 : 2, c0 : c0 + 2 * len(ts) - 1 : 2]


def _subpixel_weights(w: torch.Tensor, k: int) -> torch.Tensor:
    """Reindex a k x k OIHW kernel applied to a zero-inserted 2x upsample
    into an S x S kernel at half resolution producing 4 phase groups
    (S = k//2 + 1), each phase zero-padded to the common tap grid.  Output
    channel layout: (px*2+py)*cout + c, the px-major order of
    ops/d2s.py:depth_to_space2.  Phase (px, py) reads taps dy = 2s - py,
    dx = 2t - px for s, t in the grid's offsets; taps outside the kernel
    read the zero border of `w` padded by one."""
    kh = k // 2
    s_lo = -1 if k >= 5 else 0  # source-offset range: k=5 -> {-1,0,1}, k=3 -> {0,1}
    size = kh + 1
    wp = F.pad(w, (1, 1, 1, 1))
    phases = []
    for px in range(2):
        for py in range(2):
            r0, c0 = 2 * s_lo - py + kh + 1, 2 * s_lo - px + kh + 1
            phases.append(wp[:, :, r0 : r0 + 2 * size - 1 : 2, c0 : c0 + 2 * size - 1 : 2])
    return torch.cat(phases, 0)


def _conv(x: torch.Tensor, w: torch.Tensor, pad_h: tuple[int, int],
          pad_w: tuple[int, int]) -> torch.Tensor:
    """Stride-1 conv with padding (lo, hi) per axis: the conv's own padding
    where it is symmetric, an F.pad copy where it is not."""
    if pad_h[0] == pad_h[1] and pad_w[0] == pad_w[1]:
        return F.conv2d(x, w, padding=(pad_h[0], pad_w[0]))
    return F.conv2d(F.pad(x, (*pad_w, *pad_h)), w)


def _subpixel_convs(w: torch.Tensor) -> list[tuple[torch.Tensor, tuple[int, int], tuple[int, int]]]:
    """The convs `subpixel_unpool_conv` runs for the OIHW weight `w`, as
    (kernel, (lo, hi) padding of H, of W): with 128 or more output channels
    one exact sub-kernel per phase, px-major (no zero taps); below that one
    kernel over the zero-padded common S x S grid -- the JAX package's rule
    (decoder.py:SubpixelUnpoolConv), so the rounding follows its."""
    k = w.shape[-1]
    if w.shape[0] >= 128:
        return [(_phase_kernel(w, k, px, py), _phase_taps(k, py)[1], _phase_taps(k, px)[1])
                for px in range(2) for py in range(2)]
    pad = (1, 1) if k >= 5 else (0, 1)
    return [(_subpixel_weights(w, k), pad, pad)]


def subpixel_unpool_conv(x: torch.Tensor, w: torch.Tensor, oheight: int,
                         owidth: int) -> torch.Tensor:
    """`conv(unpool2x(x, oheight, owidth), w, padding=k//2)` as ONE
    half-resolution conv into four phase groups plus depth_to_space2.

    Equivalence: the zero-inserted rows/cols of the unpooled map contribute
    nothing, so each of the 4 output phases only reads a small sub-kernel of
    `w` at source pixels {i-1..i+1} (k=5) or {i, i+1} (k=3); cropping an
    odd final row/col before vs after the conv is identical because that
    row is an inserted zero row."""
    ys = [_conv(x, kernel, pad_h, pad_w) for kernel, pad_h, pad_w in _subpixel_convs(w)]
    return depth_to_space2(ys[0] if len(ys) == 1 else torch.cat(ys, 1), oheight, owidth)


class SubpixelUnpoolConv(nn.Conv2d):
    """`unpool2x -> crop -> k x k conv` computed by `subpixel_unpool_conv`.
    The parameter is the plain bias-free conv's (`weight`, OIHW), so state
    dicts are interchangeable with the plain form."""

    def __init__(self, cin: int, features: int, kernel: int):
        super().__init__(cin, features, kernel, padding=(kernel - 1) // 2, bias=False)

    def forward(self, x, oheight: int, owidth: int):
        return subpixel_unpool_conv(x, self.weight, oheight, owidth)


def _unpool_conv(cin: int, features: int, kernel: int, subpixel: bool) -> nn.Conv2d:
    """The first conv of a block: the same parameter in either form."""
    return SubpixelUnpoolConv(cin, features, kernel) if subpixel else conv(cin, features, kernel)


class _UnpoolBlock(nn.Module):
    """Runs a block's unpool + conv pairs in its form."""

    subpixel: bool

    def _up(self, x, oheight: int, owidth: int, *convs: nn.Conv2d) -> list[torch.Tensor]:
        if self.subpixel:
            return [c(x, oheight, owidth) for c in convs]
        x = unpool2x(x, oheight, owidth)
        return [c(x) for c in convs]


class UpProj(nn.Module):
    """Classic up-projection block (reference UpProj_Block, :126-160), plain
    form only, as in JAX.  The reference builds these for its
    `up_proj_layer1..4` path (:300-311), which its forward() never calls.
    When (oheight, owidth) are 0 the block upsamples to exactly 2x like the
    reference's scale branch (:143-146)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = conv(cin, features, 5)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = conv(features, features, 3)
        self.bn2 = nn.BatchNorm2d(features)
        self.sc_conv1 = conv(cin, features, 5)
        self.sc_bn1 = nn.BatchNorm2d(features)

    def forward(self, x, oheight: int = 0, owidth: int = 0):
        x = unpool2x(x, oheight or 2 * x.shape[2], owidth or 2 * x.shape[3])
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.sc_bn1(self.sc_conv1(x)))


class GudiUpProj(_UnpoolBlock):
    """Up-projection block without skip input (Gudi_UpProj_Block)."""

    def __init__(self, cin: int, features: int, subpixel: bool = True):
        super().__init__()
        self.subpixel = subpixel
        self.conv1 = _unpool_conv(cin, features, 5, subpixel)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = conv(features, features, 3)
        self.bn2 = nn.BatchNorm2d(features)
        self.sc_conv1 = _unpool_conv(cin, features, 5, subpixel)
        self.sc_bn1 = nn.BatchNorm2d(features)

    def forward(self, x, oheight: int, owidth: int):
        out, sc = self._up(x, oheight, owidth, self.conv1, self.sc_conv1)
        out = torch.relu(self.bn1(out))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.sc_bn1(sc))


class GudiUpProjCat(_UnpoolBlock):
    """Up-projection block with skip concatenation (Gudi_UpProj_Block_Cat)."""

    def __init__(self, cin: int, side_channels: int, features: int, subpixel: bool = True):
        super().__init__()
        self.subpixel = subpixel
        self.conv1 = _unpool_conv(cin, features, 5, subpixel)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv1_1 = conv(features + side_channels, features, 3)
        self.bn1_1 = nn.BatchNorm2d(features)
        self.conv2 = conv(features, features, 3)
        self.bn2 = nn.BatchNorm2d(features)
        self.sc_conv1 = _unpool_conv(cin, features, 5, subpixel)
        self.sc_bn1 = nn.BatchNorm2d(features)

    def forward(self, x, side_input, oheight: int, owidth: int):
        out, sc = self._up(x, oheight, owidth, self.conv1, self.sc_conv1)
        out = torch.relu(self.bn1(out))
        out = torch.cat([out, side_input], dim=1)
        out = torch.relu(self.bn1_1(self.conv1_1(out)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.sc_bn1(sc))


class GudiUpConv(_UnpoolBlock):
    """Simple up-conv block: unpool + 5x5 conv + BN + ReLU (reference
    Simple_Gudi_UpConv_Block, :162-185; built by the reference's no-skip
    decoder path)."""

    def __init__(self, cin: int, features: int, subpixel: bool = True):
        super().__init__()
        self.subpixel = subpixel
        self.conv1 = _unpool_conv(cin, features, 5, subpixel)
        self.bn1 = nn.BatchNorm2d(features)

    def forward(self, x, oheight: int, owidth: int):
        (out,) = self._up(x, oheight, owidth, self.conv1)
        return torch.relu(self.bn1(out))


class GudiUpConvLast(_UnpoolBlock):
    """Head block: unpool + 3x3 conv, raw output (no BN/ReLU)."""

    def __init__(self, cin: int, features: int, subpixel: bool = True):
        super().__init__()
        self.subpixel = subpixel
        self.conv1 = _unpool_conv(cin, features, 3, subpixel)

    def forward(self, x, oheight: int, owidth: int):
        (out,) = self._up(x, oheight, owidth, self.conv1)
        return out
