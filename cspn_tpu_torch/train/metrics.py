"""Depth metric suite (counterpart of cspn_tpu/train/metrics.py; reference
utils.py:19-57).

`evaluate_error` mirrors the reference: masked (gt > 1e-4) MSE, RMSE (sqrt
of the batch MSE), MAE, ABS_REL, threshold accuracies delta <
1.02/1.05/1.10/1.25/1.25^2/1.25^3 via max(gt/pred, pred/gt), plus iRMSE/iMAE
(inverse depth, KITTI benchmark definition) and LG10 (mean |log10 gt -
log10 pred|), both over valid pixels with pred > 1e-4, as the JAX package
computes them.  It reduces on the tensors' device and returns 0-d tensors.

`ErrorAverager` reproduces avg_error's batch-size-weighted accumulation
(utils.py:50-57), including its quirk of averaging per-batch RMSE values.
"""

from __future__ import annotations

import torch

VALID_THRESHOLD = 1e-4

METRIC_KEYS = (
    "MSE",
    "RMSE",
    "ABS_REL",
    "LG10",
    "MAE",
    "DELTA1.02",
    "DELTA1.05",
    "DELTA1.10",
    "DELTA1.25",
    "DELTA1.25^2",
    "DELTA1.25^3",
    "iRMSE",
    "iMAE",
)


def evaluate_error(gt_depth: torch.Tensor, pred_depth: torch.Tensor) -> dict:
    """Metric dict over a batch.  Shapes: any matching [..., H, W]."""
    one = torch.ones((), dtype=pred_depth.dtype, device=pred_depth.device)
    mask = gt_depth > VALID_THRESHOLD
    m = mask.to(pred_depth.dtype)
    n = m.sum().clamp_min(1.0)
    gt = torch.where(mask, gt_depth, one)
    pred = torch.where(mask, pred_depth, one)

    diff = (gt - pred).abs()
    mse = (diff**2 * m).sum() / n
    mae = (diff * m).sum() / n
    rel = (diff / gt * m).sum() / n
    ratio = torch.maximum(gt / pred, pred / gt)

    def delta(t):
        return ((ratio < t) & mask).sum() / n

    pos = mask & (pred_depth > VALID_THRESHOLD)
    mp = pos.to(pred_depth.dtype)
    np_ = mp.sum().clamp_min(1.0)
    igt = torch.where(pos, 1.0 / torch.where(pos, gt_depth, one), 0.0)
    ipred = torch.where(pos, 1.0 / torch.where(pos, pred_depth, one), 0.0)
    idiff = (igt - ipred).abs()
    irmse = torch.sqrt((idiff**2 * mp).sum() / np_)
    imae = (idiff * mp).sum() / np_

    lgt = torch.log10(torch.where(pos, gt_depth, one))
    lpred = torch.log10(torch.where(pos, pred_depth, one))
    lg10 = ((lgt - lpred).abs() * mp).sum() / np_

    return {
        "MSE": mse,
        "RMSE": torch.sqrt(mse),
        "ABS_REL": rel,
        "LG10": lg10,
        "MAE": mae,
        "DELTA1.02": delta(1.02),
        "DELTA1.05": delta(1.05),
        "DELTA1.10": delta(1.10),
        "DELTA1.25": delta(1.25),
        "DELTA1.25^2": delta(1.25**2),
        "DELTA1.25^3": delta(1.25**3),
        "iRMSE": irmse,
        "iMAE": imae,
    }


class ErrorAverager:
    """Batch-size-weighted running average (reference avg_error, utils.py:50-57)."""

    def __init__(self):
        self.sums = {k: 0.0 for k in METRIC_KEYS}
        self.total = 0

    def update(self, error: dict, batch_size: int) -> dict:
        self.total += batch_size
        for k in METRIC_KEYS:
            self.sums[k] += float(error[k]) * batch_size
        return self.average

    @property
    def average(self) -> dict:
        t = max(self.total, 1)
        return {k: self.sums[k] / t for k in METRIC_KEYS}
