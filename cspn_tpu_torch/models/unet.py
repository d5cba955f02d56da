"""ResNet-UNet depth completion with CSPN post-processing (counterpart of
cspn_tpu/models/unet.py).

NCHW PyTorch form of cspn_pytorch/models/torch_resnet_cspn_nyu.py's
`ResNet` (:278-376), with geometry derived from the input shape, the 2D
CSPN through ops/cspn.py (the Hopper kernel on CUDA tensors) or, with a
`spatial_mesh`, with its rows split over the mesh (parallel/halo.py), a
no-CSPN baseline, resnet18..152 trunks, and the decoder in its subpixel
form by default (models/decoder.py; `subpixel=False` is the plain unpool +
conv).

Input: [N, H, W, 4] RGBD, as in the JAX package; channel 3 is the sparse
depth used for anchoring.  Output: [N, H, W] dense depth.  Inside, NCHW.

`dtype=torch.bfloat16` runs the conv net in bf16 (the JAX model's
`dtype`, unet.py:88-90): the input is cast once, every conv and BN follows
its input's dtype (models/resnet.py), and the bf16 heads reach the 2D
CSPN as they are: its kernel reads bf16 and computes in float32 at every
dtype (`cspn_input_dtype`; JAX casts the heads to float32, the same
values).  `quant` swaps the encoder's
block convs and the decoder body's convs for int8 ones
(utils/quant.py:QuantConv; JAX unet.py:91-101,126-154): the stem, the
heads, the modules named in `quant_exclude` and the CSPN keep their
precision.  Serving only: a model with `quant` refuses training.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from cspn_tpu_torch.models.decoder import (
    GudiUpConvLast,
    GudiUpProj,
    GudiUpProjCat,
    subpixel_unpool_conv,
    unpool2x,
)
from cspn_tpu_torch.models.resnet import ResNetEncoder, init_weights
from cspn_tpu_torch.ops.cspn import cspn2d
from cspn_tpu_torch.parallel.halo import cspn2d_spatial
from cspn_tpu_torch.utils import quant as quant_lib


def cspn_input_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the heads of a `dtype` decoder reach the 2D CSPN in: bf16
    as it is (the kernel and the plain version read bf16 as its exact
    float32 upcast), any other promoted to float32 (float64 stays)."""
    return dtype if dtype == torch.bfloat16 else torch.promote_types(dtype, torch.float32)


def ceil_half_chain(h: int, w: int, n: int = 5) -> list[tuple[int, int]]:
    """Feature-map sizes [(H,W), (H/2,W/2), ...] using the encoder's
    ceil-halving (7x7/s2 conv, 3x3/s2 pool, 3x3/s2 convs all give ceil(n/2))."""
    sizes = [(h, w)]
    for _ in range(n):
        h, w = -(-h // 2), -(-w // 2)
        sizes.append((h, w))
    return sizes


class CSPNUNet(ResNetEncoder):
    """Encoder-decoder with dual heads (depth + affinity) and CSPN refinement.

    The encoder's modules sit at the top level, as in the reference model,
    so the state dict keys are the reference's (conv1_1, bn1, layer1..4,
    conv2, bn2, gud_up_proj_layer1..6).  `generator` seeds the JAX
    package's he_normal init of every conv (models/resnet.init_weights);
    without one the convs keep PyTorch's default init.  `subpixel` picks
    the decoder's form (models/decoder.py); both hold the same parameters
    under the same keys.  `spatial_mesh` (parallel/mesh.py:make_mesh) runs
    the CSPN with the image rows split over the mesh and halo exchange
    (`spatial_halo` K; None: the cost model's), in place of `cspn_backend`
    and `cspn_io_dtype`, as the JAX model does.  `dtype`, `quant` and
    `quant_exclude` are the module docstring's; an excluded name is a
    decoder block (gud_up_proj_layer1..4) or 'encoder' (layer1..4 and
    conv2)."""

    def __init__(
        self,
        block: str = "bottleneck",
        layers: Sequence[int] = (3, 4, 6, 3),
        cspn_steps: int = 24,
        cspn_norm_type: str = "8sum",
        use_cspn: bool = True,
        cspn_backend: str = "auto",
        cspn_io_dtype=None,
        generator: torch.Generator | None = None,
        subpixel: bool = True,
        spatial_mesh=None,
        spatial_halo: int | None = None,
        dtype: torch.dtype | None = None,
        quant: bool = False,
        quant_exclude: Sequence[str] = ("gud_up_proj_layer4",),
    ):
        super().__init__(block, layers)
        e = self.expansion
        self.block, self.layers = block, tuple(layers)
        self.subpixel = subpixel
        self.cspn_steps = cspn_steps
        self.cspn_norm_type = cspn_norm_type
        self.use_cspn = use_cspn
        self.cspn_backend = cspn_backend
        self.cspn_io_dtype = cspn_io_dtype
        self.spatial_mesh = spatial_mesh
        self.spatial_halo = spatial_halo
        self.gud_up_proj_layer1 = GudiUpProj(512 * e, 256 * e, subpixel)
        self.gud_up_proj_layer2 = GudiUpProjCat(256 * e, 128 * e, 128 * e, subpixel)
        self.gud_up_proj_layer3 = GudiUpProjCat(128 * e, 64 * e, 64 * e, subpixel)
        self.gud_up_proj_layer4 = GudiUpProjCat(64 * e, 64, 64, subpixel)
        self.gud_up_proj_layer5 = GudiUpConvLast(64, 1, subpixel)
        if use_cspn:
            self.gud_up_proj_layer6 = GudiUpConvLast(64, 8, subpixel)
        if generator is not None:
            init_weights(self, generator)
        self.dtype = dtype
        self.quant = quant
        if quant:
            names = ["gud_up_proj_layer1", "gud_up_proj_layer2", "gud_up_proj_layer3",
                     "gud_up_proj_layer4"]
            if "encoder" not in quant_exclude:
                names += ["layer1", "layer2", "layer3", "layer4", "conv2"]
            for name in names:
                if name not in quant_exclude:
                    self.add_module(name, quant_lib.quantize_convs(getattr(self, name)))

    def train(self, mode: bool = True):
        if mode and self.quant:
            raise ValueError("int8 quantization is serving-only (round has no gradient)")
        return super().train(mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4 or x.shape[-1] != 4:
            raise ValueError(f"input must be RGBD [N, H, W, 4], got {tuple(x.shape)}")
        h, w = x.shape[1:3]
        sizes = ceil_half_chain(h, w, 5)
        sparse_depth = x[..., 3].contiguous()
        x_net = x.permute(0, 3, 1, 2).contiguous()
        feats, skips = super().forward(x_net if self.dtype is None else x_net.to(self.dtype))
        d = self.gud_up_proj_layer1(feats, *sizes[4])
        d = self.gud_up_proj_layer2(d, skips["skip2"], *sizes[3])
        d = self.gud_up_proj_layer3(d, skips["skip3"], *sizes[2])
        d = self.gud_up_proj_layer4(d, skips["skip4"], *sizes[1])
        # the no-CSPN head and the sharded CSPN take float32 (float64 stays);
        # the 2D CSPN takes bf16 heads as they are (cspn_input_dtype)
        head_dtype = torch.promote_types(d.dtype, torch.float32)
        if not self.use_cspn:
            return self.gud_up_proj_layer5(d, *sizes[0])[:, 0].to(head_dtype)
        # one 9-channel head conv (channel 0 = depth, 1..8 = affinity): the
        # two heads' weights keep their own modules and are concatenated
        # along cout, the JAX package's fused head (unet.py:156-181); in the
        # subpixel form one reindexed 2x2 conv, padded (0,1),(0,1), and one
        # depth_to_space2 to the full size
        w_heads = torch.cat(
            [self.gud_up_proj_layer5.conv1.weight, self.gud_up_proj_layer6.conv1.weight]
        ).to(d.dtype)
        if self.subpixel:
            heads = subpixel_unpool_conv(d, w_heads, *sizes[0])
        else:
            heads = F.conv2d(unpool2x(d, *sizes[0]), w_heads, padding=1)
        if self.spatial_mesh is not None:
            heads = heads.to(head_dtype)
            return cspn2d_spatial(
                heads[:, 1:],
                heads[:, 0],
                sparse_depth,
                mesh=self.spatial_mesh,
                steps=self.cspn_steps,
                norm_type=self.cspn_norm_type,
                halo=self.spatial_halo,
                channel_first=True,
            )
        heads = heads.to(cspn_input_dtype(d.dtype))
        return cspn2d(
            heads[:, 1:],
            heads[:, 0].contiguous(),
            sparse_depth,
            steps=self.cspn_steps,
            norm_type=self.cspn_norm_type,
            backend=self.cspn_backend,
            io_dtype=self.cspn_io_dtype,
            channel_first=True,
        )


LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _make(depth: int, use_cspn: bool, **kwargs) -> CSPNUNet:
    block, layers = LAYERS[depth]
    return CSPNUNet(block=block, layers=layers, use_cspn=use_cspn, **kwargs)


def cspn_unet_resnet18(**kw):
    """KITTI trunk (reference train.py:146-147 uses resnet18 for KITTI)."""
    return _make(18, True, **kw)


def cspn_unet_resnet34(**kw):
    return _make(34, True, **kw)


def cspn_unet_resnet50(**kw):
    """NYU flagship (reference train.py:142-144)."""
    return _make(50, True, **kw)


def cspn_unet_resnet101(**kw):
    return _make(101, True, **kw)


def cspn_unet_resnet152(**kw):
    return _make(152, True, **kw)


def unet_baseline_resnet18(**kw):
    """No-CSPN baseline (the reference's missing `torch_resnet`)."""
    return _make(18, False, **kw)


def unet_baseline_resnet50(**kw):
    return _make(50, False, **kw)
