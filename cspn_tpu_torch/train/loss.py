"""Losses (counterpart of cspn_tpu/train/loss.py; reference loss.py).

The reference trains with masked mean-L1 (`Wighted_L1_Loss`, loss.py:16-23):
valid pixels are label > 1e-4; loss = sum|pred - label| / n_valid.  berHu
(from the TPAMI paper) is the option.
"""

from __future__ import annotations

import torch

VALID_THRESHOLD = 1e-4


def masked_l1_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Masked mean absolute error over valid (label > 1e-4) pixels."""
    mask = (label > VALID_THRESHOLD).to(pred.dtype)
    n_valid = mask.sum().clamp_min(1.0)
    return ((pred - label).abs() * mask).sum() / n_valid


def berhu_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Reverse-Huber: L1 below threshold c, (d^2 + c^2) / (2c) above,
    c = 0.2 * max|d| over valid pixels."""
    mask = (label > VALID_THRESHOLD).to(pred.dtype)
    n_valid = mask.sum().clamp_min(1.0)
    diff = (pred - label).abs() * mask
    c = (0.2 * diff.max()).clamp_min(1e-6)
    per_px = torch.where(diff <= c, diff, (diff**2 + c**2) / (2.0 * c))
    return (per_px * mask).sum() / n_valid


LOSSES = {"l1": masked_l1_loss, "berhu": berhu_loss}
