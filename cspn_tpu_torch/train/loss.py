"""Losses (counterpart of cspn_tpu/train/loss.py; reference loss.py).

The reference trains with masked mean-L1 (`Wighted_L1_Loss`, loss.py:16-23):
valid pixels are label > 1e-4; loss = sum|pred - label| / n_valid.  berHu
(from the TPAMI paper) is the option.

berHu's threshold is 0.2 x the largest |d| of the batch.  Under data
parallelism on the sync-BN route (parallel/data.py) the JAX package's GSPMD
step takes it over the global batch, so `berhu_loss(..., group=)` takes the
largest |d| over every rank of `group` (`_GroupMax`), and the threshold's
gradient reaches the pixel that holds it on whichever rank that is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

VALID_THRESHOLD = 1e-4


def masked_l1_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Masked mean absolute error over valid (label > 1e-4) pixels."""
    mask = (label > VALID_THRESHOLD).to(pred.dtype)
    n_valid = mask.sum().clamp_min(1.0)
    return ((pred - label).abs() * mask).sum() / n_valid


class _GroupMax(torch.autograd.Function):
    """The largest value of `x` over every rank of `group`.  Its gradient is
    jnp.max's over the joined values: the ranks' cotangents summed, split
    equally among the elements, on any rank, that hold the maximum."""

    @staticmethod
    def forward(ctx, x, group):
        top = x.detach().max().reshape(1).clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        ctx.group = group
        ctx.save_for_backward(x.detach() == top)
        return top[0]

    @staticmethod
    def backward(ctx, ct):
        (hits,) = ctx.saved_tensors
        sums = torch.stack([ct.to(torch.float64), hits.sum().to(torch.float64)])
        dist.all_reduce(sums, group=ctx.group)  # every rank's cotangent, every rank's ties
        return hits.to(ct.dtype) * (sums[0] / sums[1]).to(ct.dtype), None


def berhu_loss(pred: torch.Tensor, label: torch.Tensor, group=None) -> torch.Tensor:
    """Reverse-Huber: L1 below threshold c, (d^2 + c^2) / (2c) above,
    c = 0.2 * max|d| over valid pixels; with a process `group`, max|d| over
    the valid pixels of every rank's batch (the global batch's threshold)."""
    mask = (label > VALID_THRESHOLD).to(pred.dtype)
    n_valid = mask.sum().clamp_min(1.0)
    diff = (pred - label).abs() * mask
    top = diff.max() if group is None else _GroupMax.apply(diff, group)
    c = (0.2 * top).clamp_min(1e-6)
    per_px = torch.where(diff <= c, diff, (diff**2 + c**2) / (2.0 * c))
    return (per_px * mask).sum() / n_valid


LOSSES = {"l1": masked_l1_loss, "berhu": berhu_loss}
