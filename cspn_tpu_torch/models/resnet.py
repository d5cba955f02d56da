"""ResNet encoder for depth completion (counterpart of cspn_tpu/models/resnet.py).

NCHW PyTorch form of the encoder half of
cspn_pytorch/models/torch_resnet_cspn_nyu.py, with the reference model's
module names (conv1_1, bn1, layer1..4, conv2, bn2), so its state dict and
the converted JAX parameters (models/convert.py) load by name:
  - 4-channel RGBD stem: 7x7/s2 conv, padding 3 (the JAX package's
    space-to-depth stem is a TPU rewrite of this same conv),
  - BasicBlock (expansion 1) and Bottleneck (expansion 4),
  - stages layer1..layer4 with 1x1 strided downsample shortcuts,
  - trailing conv2 + bn2, no ReLU.

Skip maps for the decoder: skip4 = stem conv output *before* BN/ReLU,
skip3 = layer1 output, skip2 = layer2 output.

BatchNorm is `nn.BatchNorm2d` at torch defaults (eps 1e-5, momentum 0.1):
biased batch variance to normalize, unbiased variance in the running-stat
update -- the semantics the JAX package's `_TorchStatsBatchNorm` emulates.

Mixed precision (the JAX modules' `dtype`): the activations' dtype flows
from the model's input.  A conv computes in its input's dtype, casting a
float32 master weight to a bf16 input's (`Conv2d`; JAX's `nn.Conv(dtype=)`);
a BN (`BatchNorm2d`, `BatchNorm3d`) takes a bf16 input with float32
(training) or bf16 (serving, utils/precision.py) parameters and writes
bf16.  Its batch statistics are float32, JAX's promote(dtype, f32)
(resnet.py:65-69); the normalization runs in the promoted dtype of its
input, statistics and parameters, as JAX's does (resnet.py:96-112): float32
rounded once on float32 parameters, and on the serving weights in bf16,
each of x - mean, rsqrt(var + eps) * scale, the product and + bias rounded
in turn.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

# flax he_normal: variance_scaling(2, fan_in, truncated normal at +-2 std),
# whose stddev is corrected for the truncation by this constant
_TRUNC_STD = 0.87962566103423978


def he_normal_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """In-place flax-style he_normal init of an OIHW conv weight."""
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        # standard normal truncated at +-2 by redrawing the tails (~5% of
        # draws); an order of magnitude faster on the CPU than
        # nn.init.trunc_normal_'s inverse-CDF form
        w.normal_(generator=generator)
        tail = w.abs() > 2.0
        while tail.any():
            w[tail] = torch.randn(int(tail.sum()), generator=generator, device=w.device)
            tail = w.abs() > 2.0
        return w.mul_(std)


def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Re-initialize every conv of `module` with he_normal from `generator`
    (BN keeps weight 1, bias 0, running stats 0/1), in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            he_normal_(m.weight, generator)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in its input's dtype: a float32 weight is cast
    to a bf16 input's (the master weight keeps its dtype and its gradient)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias)


class Conv3d(nn.Conv3d):
    """`nn.Conv3d` computing in its input's dtype, as `Conv2d`."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias)


class NormInPromotedDtype:
    """Batch-norm mixin: eval-mode normalization in the promoted dtype of
    the input, the running statistics and the parameters, as the JAX
    package's BatchNorm computes it (resnet.py:96-112).  Where that is bf16
    (the serving weights cast by utils/precision.py), each op rounds to
    bf16 in JAX's order; elsewhere torch's batch norm, which normalizes in
    float32 and rounds once."""

    def forward(self, x):
        if self.training or self.running_mean is None or torch.promote_types(
                torch.promote_types(x.dtype, self.running_mean.dtype),
                self.weight.dtype) != torch.bfloat16:
            return super().forward(x)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class BatchNorm2d(NormInPromotedDtype, nn.BatchNorm2d):
    """`nn.BatchNorm2d` normalizing in the JAX package's dtype (module docstring)."""


class BatchNorm3d(NormInPromotedDtype, nn.BatchNorm3d):
    """`nn.BatchNorm3d` normalizing in the JAX package's dtype, as `BatchNorm2d`."""


def conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    """Bias-free conv with torch-style symmetric padding."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    # downsample.0 = conv, downsample.1 = bn (torchvision _make_layer names)
    return nn.Sequential(conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride) if downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = _downsample(inplanes, planes * 4, stride) if downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class ResNetEncoder(nn.Module):
    """Encoder trunk; forward(x NCHW) returns (bottleneck, skips dict)."""

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (3, 4, 6, 3),
                 in_channels: int = 4, in_stem_features: int = 64):
        super().__init__()
        block_cls = BLOCKS[block]
        self.expansion = block_cls.expansion
        self.conv1_1 = Conv2d(in_channels, in_stem_features, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(in_stem_features)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = in_stem_features
        for stage, (planes, n_blocks, stride) in enumerate(
            zip((64, 128, 256, 512), layers, (1, 2, 2, 2)), start=1
        ):
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                need_ds = b == 0 and (s != 1 or inplanes != planes * self.expansion)
                blocks.append(block_cls(inplanes, planes, s, need_ds))
                inplanes = planes * self.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.conv2 = conv(inplanes, 512 * self.expansion, 3)
        self.bn2 = BatchNorm2d(512 * self.expansion)

    def forward(self, x):
        skips = {}
        x = self.conv1_1(x)
        skips["skip4"] = x  # pre-BN stem output
        x = self.maxpool(torch.relu(self.bn1(x)))
        x = self.layer1(x)
        skips["skip3"] = x
        x = self.layer2(x)
        skips["skip2"] = x
        x = self.layer4(self.layer3(x))
        return self.bn2(self.conv2(x)), skips
