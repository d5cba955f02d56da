"""Gudi up-projection decoder blocks (counterpart of cspn_tpu/models/decoder.py).

NCHW PyTorch form of the decoder half of
cspn_pytorch/models/torch_resnet_cspn_nyu.py, in the reference model's own
form: `unpool2x` (zero-insert 2x upsample) followed by a k x k conv.  The
JAX package computes the same function as a half-resolution subpixel conv
plus depth-to-space, a TPU rewrite whose output its golden test pins equal
to this form (tests/test_golden.py:56-65).

  - `GudiUpProj`     <- Gudi_UpProj_Block (:208-240)
  - `GudiUpProjCat`  <- Gudi_UpProj_Block_Cat (:243-276), concatenates a skip
    map after the first conv (:270)
  - `GudiUpConvLast` <- Simple_Gudi_UpConv_Block_Last_Layer (:187-206), raw
    head output (no BN/ReLU)

Blocks crop the 2x-unpooled map to (oheight, owidth), which the model
derives from the input shape and passes to forward.
"""

from __future__ import annotations

import torch
from torch import nn

from cspn_tpu_torch.models.resnet import conv


def unpool2x(x: torch.Tensor, oheight: int, owidth: int) -> torch.Tensor:
    """Zero-insert 2x upsample (value at top-left of each 2x2 cell), then
    crop to (oheight, owidth).  x: [N, C, H, W]."""
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, 2 * h, 2 * w))
    out[:, :, ::2, ::2] = x
    return out[:, :, :oheight, :owidth]


class GudiUpProj(nn.Module):
    """Up-projection block without skip input (Gudi_UpProj_Block)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = conv(cin, features, 5)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = conv(features, features, 3)
        self.bn2 = nn.BatchNorm2d(features)
        self.sc_conv1 = conv(cin, features, 5)
        self.sc_bn1 = nn.BatchNorm2d(features)

    def forward(self, x, oheight: int, owidth: int):
        x = unpool2x(x, oheight, owidth)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.sc_bn1(self.sc_conv1(x)))


class GudiUpProjCat(nn.Module):
    """Up-projection block with skip concatenation (Gudi_UpProj_Block_Cat)."""

    def __init__(self, cin: int, side_channels: int, features: int):
        super().__init__()
        self.conv1 = conv(cin, features, 5)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv1_1 = conv(features + side_channels, features, 3)
        self.bn1_1 = nn.BatchNorm2d(features)
        self.conv2 = conv(features, features, 3)
        self.bn2 = nn.BatchNorm2d(features)
        self.sc_conv1 = conv(cin, features, 5)
        self.sc_bn1 = nn.BatchNorm2d(features)

    def forward(self, x, side_input, oheight: int, owidth: int):
        x = unpool2x(x, oheight, owidth)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.cat([out, side_input], dim=1)
        out = torch.relu(self.bn1_1(self.conv1_1(out)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + self.sc_bn1(self.sc_conv1(x)))


class GudiUpConvLast(nn.Module):
    """Head block: unpool + 3x3 conv, raw output (no BN/ReLU)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = conv(cin, features, 3)

    def forward(self, x, oheight: int, owidth: int):
        return self.conv1(unpool2x(x, oheight, owidth))
