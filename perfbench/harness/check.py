"""The comparison that decides `correct`: the numbers compared, each held
to its limit from perfbench/limits/<workload>.json.

Served depth (every frame of the sampled requests against the float32
reference on the same frames): `<path>_rel_err`, the largest over the
frames the server computed on that numeric path of
||served - reference||_2 / ||reference||_2.

Training (the program's first three steps against the reference's from
the same weights and batches):
  - `loss_gap`: the largest over the steps of |loss - loss_ref| / |loss_ref|;
  - `grad_norm_gap`: over the leaves, the largest gap between the norm of
    the program's first gradient as its optimizer took it and the
    reference's, over the larger of the reference leaf's norm and the
    median leaf's;
  - `change_norm_gap`: the same of the parameters' change over the three
    steps, leaving out the leaves whose reference gradient is under a
    thousandth of the median leaf's (they move by round-off alone);
  - `change_gap_median`: the median over those leaves of the same gap, the
    steady number where the worst leaf's is the rounding of small leaves
    (PERF.md, nyu_train_b8).
The cell's limits file names the numbers compared; a number it does not
name is logged but not compared.  A compared number that is not finite
is not correct.
"""

from __future__ import annotations

import math
import statistics

import torch


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> list[float]:
    """Per frame ||out - ref|| / ||ref|| of [n, H, W] maps."""
    out, ref = out.double().flatten(1), ref.double().flatten(1)
    return ((out - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)).tolist()


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> list[float]:
    """Per leaf |prog - ref| over the larger of ref's leaf and median leaf."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[k] for k in ref)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def norm_gap(prog: dict, ref: dict, leaves=None) -> float:
    return max(leaf_gaps(prog, ref, leaves))


def small_leaves(ref_grad_norms: dict) -> set:
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v < 1e-3 * med}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number the limits
    name; correct needs at least one, and each finite and within its limit."""
    checks = {name: {"value": v, "limit": limits[name]["limit"]}
              for name, v in numbers.items() if name in limits}
    ok = bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
