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

Every conv-BN(-add)(-ReLU) of the blocks goes through `conv_bn`: where the
conv is an int8 QuantConv on the card and the BN normalizes in bf16, the
conv's dequantize kernel applies the BN, the residual add and the ReLU in
its epilogue (utils/quant.py, csrc/int8_conv.cu), with the same bits;
everywhere else they run op by op as written.
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

    def bf16_params(self, dtype: torch.dtype) -> tuple | None:
        """(mean, mul, bias) [C] of the bf16 normalization of a `dtype`
        input, mul = rsqrt(var + eps) * weight; None where this BN
        normalizes otherwise (training, no running statistics, a promoted
        dtype other than bf16)."""
        if self.training or self.running_mean is None or torch.promote_types(
                torch.promote_types(dtype, self.running_mean.dtype),
                self.weight.dtype) != torch.bfloat16:
            return None
        return self.running_mean, torch.rsqrt(self.running_var + self.eps) * self.weight, self.bias

    def forward(self, x):
        params = self.bf16_params(x.dtype)
        if params is None:
            return super().forward(x)
        return norm_bf16(x, *params)


def norm_bf16(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """(x - mean) * mul + bias over dim 1, each op rounded to x's dtype."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean.view(shape)) * mul.view(shape) + bias.view(shape)


class BatchNorm2d(NormInPromotedDtype, nn.BatchNorm2d):
    """`nn.BatchNorm2d` normalizing in the JAX package's dtype (module docstring)."""


class BatchNorm3d(NormInPromotedDtype, nn.BatchNorm3d):
    """`nn.BatchNorm3d` normalizing in the JAX package's dtype, as `BatchNorm2d`."""


def conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    """Bias-free conv with torch-style symmetric padding."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)


def bn_epilogue(conv: nn.Module, bn: nn.Module, x: torch.Tensor) -> tuple | None:
    """The BN's bf16 (mean, mul, bias) where `conv` takes it into its own
    epilogue: a conv that has one (`fuses_bn`: utils/quant.py:QuantConv,
    whose `int8_dequant` applies it on the card) on a CUDA input, and an
    eval BN normalizing in bf16.  None: the BN runs op by op."""
    if not (x.is_cuda and getattr(conv, "fuses_bn", False) and isinstance(bn, NormInPromotedDtype)):
        return None
    return bn.bf16_params(x.dtype)


def conv_bn(conv: nn.Module, bn: nn.Module, x: torch.Tensor, *args,
            residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """relu?(bn(conv(x, *args)) [+ residual]): every block's conv-BN(-add)
    (-ReLU).  Where `bn_epilogue` finds one, the conv's epilogue computes
    it, with the same bits; elsewhere (the CPU, training, float BNs, convs
    without one) the ops run one by one."""
    params = bn_epilogue(conv, bn, x)
    if params is not None:
        return conv(x, *args, bn=params, residual=residual, relu=relu)
    out = bn(conv(x, *args))
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


def conv_bn_pairs(model: nn.Module):
    """Each (conv, BN) the blocks hand to `conv_bn`, by the reference's
    module names: a conv `<p>conv<s>` and its sibling `<p>bn<s>` (conv1 /
    bn1, conv1_1 / bn1_1, sc_conv1 / sc_bn1, the trunk's conv2 / bn2), a
    downsample's `0` and `1`."""
    for parent in model.modules():
        children = dict(parent.named_children())
        for name, m in children.items():
            bn = children.get("1" if name == "0" else name.replace("conv", "bn", 1))
            if isinstance(m, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d):
                yield m, bn


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
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        residual = x if self.downsample is None else conv_bn(self.downsample[0],
                                                             self.downsample[1], x)
        return conv_bn(self.conv2, self.bn2, out, residual=residual, relu=True)


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
        out = conv_bn(self.conv1, self.bn1, x, relu=True)
        out = conv_bn(self.conv2, self.bn2, out, relu=True)
        residual = x if self.downsample is None else conv_bn(self.downsample[0],
                                                             self.downsample[1], x)
        return conv_bn(self.conv3, self.bn3, out, residual=residual, relu=True)


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
        return conv_bn(self.conv2, self.bn2, x), skips
