"""Stereo matching with 3D CSPN cost-volume refinement (counterpart of
cspn_tpu/models/stereo.py; BASELINE config 5).

  left/right [N,H,W,3]
    -> shared 2D feature extractor (stride 4)          [N,C,H/4,W/4]
    -> concat cost volume over D/4 disparities          [N,2C,D/4,H/4,W/4]
    -> 3D conv hourglass                                [N,C,D/4,H/4,W/4]
    -> cost head (1 ch) + 3D guidance head (26 ch), one fused conv
    -> 3D CSPN refinement (ops/cspn.py:cspn_nd: the Hopper kernels on
       CUDA tensors, paddle semantics; with a spatial mesh, D split over it,
       parallel/halo.py:cspn_nd_spatial)               [N,1,D/4,H/4,W/4]
    -> trilinear upsample (ops/resize.py)               [N,D,H,W]
    -> softmax disparity regression                     [N,H,W]

Inputs and output keep the JAX package's layout ([N,H,W,3] in, [N,H,W]
out); inside, NCHW / NCDHW.  Module names follow the JAX parameter tree,
so models/convert.py maps it by name (`Conv_0` -> `conv`).  The JAX
package's `conv3d_batched2d` is a TPU rewrite of a 3x3x3 conv; here it is
`nn.Conv3d(padding=1, bias=False)`, whose stride-2 output size
`(d - 1) // 2 + 1` is the same.  BN is torch's (eps 1e-5, momentum 0.1), the
semantics the JAX package's BatchNorm emulates.  The heads, the CSPN and
the regression run in float32 (float64 stays float64), as the JAX model
casts its heads to float32.  `dtype=torch.bfloat16` (or 'bfloat16') runs
the feature extractor, the cost volume, the hourglass and the heads' conv
in bf16 on float32 parameters (the JAX modules' `dtype`, stereo.py:39-68):
the inputs are cast once and every conv and BN follows its input's dtype
(models/resnet.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cspn_tpu_torch.models.resnet import BatchNorm2d, BatchNorm3d, Conv3d, conv, he_normal_
from cspn_tpu_torch.ops.cspn import cspn_nd
from cspn_tpu_torch.ops.resize import resize_trilinear
from cspn_tpu_torch.parallel.halo import cspn_nd_spatial
from cspn_tpu_torch.utils.precision import torch_dtype

# PSMNetCSPN.forward's stages, in order (utils/profiling.py times each)
STAGES = ("feature extractor", "cost volume", "hourglass", "heads", "3D CSPN",
          "upsample + regression")


def lecun_normal_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """In-place flax-style lecun_normal init (variance 1 / fan_in, normal
    truncated at +-2 std) of an O, I, *kernel weight."""
    he_normal_(w, generator)  # variance 2 / fan_in
    with torch.no_grad():
        return w.mul_(math.sqrt(0.5))


class _ConvBnRelu(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = conv(cin, features, 3, stride)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class StereoFeatureExtractor(nn.Module):
    """Small residual CNN, output stride 4, shared between views."""

    def __init__(self, features: int = 32, in_channels: int = 3):
        super().__init__()
        f = features
        self.stem1 = _ConvBnRelu(in_channels, f, stride=2)
        self.stem2 = _ConvBnRelu(f, f)
        self.down = _ConvBnRelu(f, 2 * f, stride=2)
        for i in range(2):  # residual refinement
            setattr(self, f"res{i}a", _ConvBnRelu(2 * f, 2 * f))
            setattr(self, f"res{i}b", conv(2 * f, 2 * f, 3))
            setattr(self, f"res{i}bn", BatchNorm2d(2 * f))
        self.proj = conv(2 * f, f, 1)  # no bn/relu on matching features

    def forward(self, x):
        x = self.down(self.stem2(self.stem1(x)))
        for i in range(2):
            h = getattr(self, f"res{i}a")(x)
            h = getattr(self, f"res{i}bn")(getattr(self, f"res{i}b")(h))
            x = torch.relu(x + h)
        return self.proj(x)


def build_cost_volume(fl: torch.Tensor, fr: torch.Tensor, num_disp: int) -> torch.Tensor:
    """Concatenation cost volume (PSMNet style).

    fl, fr: [N, C, H, W] left/right features.  Returns [N, 2C, num_disp, H,
    W]: channels [fl, fr_d], where fr_d is fr shifted right by d, zero in
    the columns < d (no match inside the image).  Built out of place: the
    backward of `num_disp` slice assignments into one volume would copy the
    whole volume's gradient once per assignment."""
    w = fl.shape[-1]
    right = torch.stack([F.pad(fr[..., : max(w - d, 0)], (min(d, w), 0)) for d in range(num_disp)],
                        dim=2)
    return torch.cat([fl.unsqueeze(2).expand_as(right), right], dim=1)


def conv3d(cin: int, cout: int, stride: int = 1) -> nn.Conv3d:
    """Bias-free 3x3x3 conv, padding 1 (the JAX package's Conv3d), in its
    input's dtype."""
    return Conv3d(cin, cout, 3, stride=stride, padding=1, bias=False)


class Hourglass3D(nn.Module):
    """3D conv encoder-decoder over [N, C, D, H, W]."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        f = features
        layers = (("conv0", "bn0", in_channels, f, 1), ("down1", "bn1", f, 2 * f, 2),
                  ("conv1", "bn1b", 2 * f, 2 * f, 1), ("down2", "bn2", 2 * f, 2 * f, 2),
                  ("conv2", "bn2b", 2 * f, 2 * f, 1), ("up1", "bnu1", 2 * f, 2 * f, 1),
                  ("up0", "bnu0", 2 * f, f, 1))
        for conv_name, bn_name, cin, cout, stride in layers:
            setattr(self, conv_name, conv3d(cin, cout, stride))
            setattr(self, bn_name, BatchNorm3d(cout))

    def forward(self, x):
        x0 = torch.relu(self.bn0(self.conv0(x)))
        d1 = torch.relu(self.bn1(self.down1(x0)))
        d1 = torch.relu(self.bn1b(self.conv1(d1)))
        d2 = torch.relu(self.bn2(self.down2(d1)))
        d2 = torch.relu(self.bn2b(self.conv2(d2)))
        u1 = resize_trilinear(d2, d1.shape[2:], channel_first=True)
        u1 = torch.relu(self.bnu1(self.up1(u1)) + d1)
        u0 = resize_trilinear(u1, x0.shape[2:], channel_first=True)
        return torch.relu(self.bnu0(self.up0(u0)) + x0)


class PSMNetCSPN(nn.Module):
    """Stereo disparity network with 3D-CSPN cost refinement.

    `generator` seeds the JAX package's init of every conv (he_normal, the
    two heads lecun_normal); without one the convs keep PyTorch's default
    init.  `guidance_zero_init` zeroes the 26-gate guidance head (the CSPN
    is then an exact identity).  `cspn_backend` is ops/cspn.py's, and the
    attribute `cspn_gate_dtype` (None) its `gate_dtype`: None reads the 3D
    gates in bf16 on the kernels and in float32 on the reference, as the
    JAX package's backends do; a plain twin of the kernel route sets it to
    bf16.  `spatial_mesh` (parallel/mesh.py:make_mesh) runs the 3D CSPN
    with the cost volume's D axis split over the mesh and halo exchange
    (`spatial_halo` K; None: the cost model's), as the JAX model does."""

    def __init__(
        self,
        max_disp: int = 192,
        features: int = 32,
        cspn_steps: int = 24,
        use_cspn: bool = True,
        guidance_zero_init: bool = False,
        dtype=None,
        spatial_mesh=None,
        spatial_halo: int | None = None,
        cspn_backend: str = "auto",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        if dtype == "int8":
            raise ValueError("the stereo model has no int8 form")
        self.cspn_gate_dtype = None
        self.max_disp = max_disp
        self.cspn_steps = cspn_steps
        self.use_cspn = use_cspn
        self.cspn_backend = cspn_backend
        self.spatial_mesh = spatial_mesh
        self.spatial_halo = spatial_halo
        self.feature = StereoFeatureExtractor(features)
        self.hourglass = Hourglass3D(2 * features, features)
        self.cost_head = conv3d(features, 1)
        if use_cspn:
            self.guidance3d_head = conv3d(features, 26)
        if generator is not None:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                    he_normal_(m.weight, generator)
            lecun_normal_(self.cost_head.weight, generator)
            if use_cspn:
                lecun_normal_(self.guidance3d_head.weight, generator)
        if use_cspn and guidance_zero_init:
            nn.init.zeros_(self.guidance3d_head.weight)

    def forward(self, left: torch.Tensor, right: torch.Tensor, mark=None) -> torch.Tensor:
        """left/right [N, H, W, 3] -> disparity [N, H, W].  `mark(stage)`,
        when given, is called after each of STAGES."""
        mark = mark or (lambda stage: None)
        n, h, w, _ = left.shape
        dt = left.dtype if self.dtype is None else self.dtype
        fl = self.feature(left.permute(0, 3, 1, 2).contiguous().to(dt))
        fr = self.feature(right.permute(0, 3, 1, 2).contiguous().to(dt))
        mark(STAGES[0])
        cost = build_cost_volume(fl, fr, self.max_disp // 4)
        mark(STAGES[1])
        cost = self.hourglass(cost)
        mark(STAGES[2])
        # the cost head (1 ch) and the guidance head (26 ch) as one 27-channel
        # conv (the JAX package's fused heads, stereo.py:286-302); the two
        # weights keep their own modules
        wk = self.cost_head.weight
        if self.use_cspn:
            wk = torch.cat([wk, self.guidance3d_head.weight])
        heads = F.conv3d(cost, wk.to(cost.dtype), padding=1)
        heads = heads.to(torch.promote_types(heads.dtype, torch.float32))
        logits = heads[:, :1]
        mark(STAGES[3])
        if self.use_cspn and self.spatial_mesh is not None:
            logits = cspn_nd_spatial(heads[:, 1:], logits, mesh=self.spatial_mesh, kernel_size=3,
                                     steps=self.cspn_steps, halo=self.spatial_halo,
                                     channel_first=True)
        elif self.use_cspn:
            logits = cspn_nd(heads[:, 1:], logits, kernel_size=3, steps=self.cspn_steps,
                             backend=self.cspn_backend, channel_first=True,
                             gate_dtype=self.cspn_gate_dtype)
        mark(STAGES[4])
        full = resize_trilinear(logits, (self.max_disp, h, w), channel_first=True)[:, 0]
        # softmax disparity regression over the D axis
        probs = torch.softmax(full, dim=1)
        disp_values = torch.arange(self.max_disp, dtype=probs.dtype, device=probs.device)
        out = (probs * disp_values[None, :, None, None]).sum(dim=1)
        mark(STAGES[5])
        return out


def smooth_l1_disparity_loss(pred: torch.Tensor, gt: torch.Tensor, max_disp: float) -> torch.Tensor:
    """Masked smooth-L1 (valid: 0 < gt < max_disp), PSMNet training loss."""
    mask = ((gt > 0) & (gt < max_disp)).to(pred.dtype)
    n = mask.sum().clamp_min(1.0)
    d = (pred - gt).abs()
    per_px = torch.where(d < 1.0, 0.5 * d**2, d - 0.5)
    return (per_px * mask).sum() / n


def end_point_error(pred: torch.Tensor, gt: torch.Tensor, max_disp: float) -> dict:
    """Stereo metrics over valid pixels (0 < gt < max_disp): EPE (mean abs
    disparity error), >3px error rate, and D1 (the KITTI convention: wrong
    if the error is both > 3 px and > 5% of the true disparity)."""
    mask = (gt > 0) & (gt < max_disp)
    m = mask.float()
    n = m.sum().clamp_min(1.0)
    d = (pred - gt).abs()
    return {
        "EPE": (d * m).sum() / n,
        "3px": ((d > 3.0) & mask).float().sum() / n,
        "D1": ((d > 3.0) & (d > 0.05 * gt) & mask).float().sum() / n,
    }
