"""Training traffic (`"kind": "train"`): the program's train step, eager, on
batches made on the device from the seed.

Set-up makes the weights and a pool of `pool_batches` distinct batches,
builds the step (systems/<system>.py:trainer) and drives it through its
first `checked_steps` steps on the pool's first batches: these time cuDNN's
algorithms and warm every kernel, and they are the steps the output check
compares.  After the first it reads the gradient the optimizer took, after
the last the change of every parameter; then the same step object runs
the window, on the pool's next batches in turn, until the window's seconds
have passed.  A synchronization closes the window: `train_frames_per_s` is
the frames of every step over the time from the window's start to it.  A
step whose loss is not finite has failed.

The output check runs the reference's first steps from the same weights
on the same batches, once the program's state is freed (harness/check.py).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from perfbench.harness import check, data, weights
from perfbench.harness.trace import Tracer, span


def _batches(cfg: dict, tr: dict, seed: int, dev) -> list:
    n, b = tr["pool_batches"], tr["batch"]
    rgbd, depth = data.frames(n * b, *cfg["frame"], cfg["n_sample"],
                              data.generator(seed, data.BATCHES, dev), dev)
    return [(rgbd[i * b:(i + 1) * b], depth[i * b:(i + 1) * b]) for i in range(n)]


@torch.no_grad()
def _change_norms(params: dict, start: dict) -> dict:
    return {k: float((p.detach() - start[k]).float().norm()) for k, p in params.items()}


def run(ctx) -> dict:
    cell, dev, seed, sysm = ctx.cell, ctx.device, ctx.seed, ctx.system
    cfg, tr = cell.config, cell.traffic
    k = tr["checked_steps"]
    w0 = weights.make(cfg["arch"], seed, dev, cfg["in_channels"])
    step, model, opt = sysm.trainer(cfg, w0, dev)
    del w0
    ctx.stage("step built")
    pool = _batches(cfg, tr, seed, dev)
    losses = []
    for i in range(k):
        loss, _ = step(*pool[i])
        losses.append(loss)
        if i == 0:
            g1 = sysm.first_gradient_norms(model, opt)
        ctx.stage(f"step {i + 1}")
    change = _change_norms(dict(model.named_parameters()),
                           weights.make(cfg["arch"], seed, dev, cfg["in_channels"]))
    tracer = Tracer(dev) if ctx.trace else None
    if tracer:
        tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.monotonic() - ctx.t_process

    window_losses = []
    b = tr["batch"]
    trace_from = tr["trace_at"] * ctx.seconds
    traced = 0
    i = k
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        if tracer and not tracer.active and tracer.prof is None \
                and time.perf_counter() - t0 >= trace_from:
            tracer.start(window=False)
        with span("perfbench.step"):
            loss, _ = step(*pool[i % len(pool)])
        window_losses.append(loss)
        i += 1
        if tracer and tracer.active:
            if tracer.mark is None:  # the window opens after the first traced step
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                tracer.open()
                continue
            traced += 1
            if traced == tr["trace_steps"]:
                tracer.stop(traced * b)
    if tracer and tracer.active:
        tracer.stop(traced * b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    trace = tracer.finish() if tracer else None
    n = len(window_losses)
    finite = torch.isfinite(torch.stack(window_losses)).tolist() if n else []
    failed = n - sum(finite)
    metrics = {"setup_s": setup_s, "train_frames_per_s": n * b / elapsed}
    prog_losses = [float(x) for x in losses]
    ctx.log(f"# window: {n} steps in {elapsed:.3f} s; first losses {prog_losses}, "
            f"last {float(window_losses[-1]) if n else math.nan}")

    device_fields = ctx.device_fields()
    del step, model, opt, window_losses, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare(ctx, pool[:k], prog_losses, g1, change)
    ctx.log(f"# reference: {k} steps in {time.perf_counter() - t_ref:.1f} s; "
            f"numbers {numbers}")
    ok, checks = check.judge(numbers, cell.limits)
    return {
        "correct": ok and failed == 0,
        "attempted": n,
        "failed": failed,
        "metrics": metrics,
        "device": device_fields,
        "checks": checks,
        "readings": {"trace": trace, "numbers": numbers},
    }


def compare(ctx, batches, prog_losses, prog_g1, prog_change, **ref_kw) -> dict:
    """The compared numbers of the program's first steps against the
    reference's (`ref_kw`: the reference's control or fault switches)."""
    cfg, dev, seed, sysm = ctx.cell.config, ctx.device, ctx.seed, ctx.system
    w0 = weights.make(cfg["arch"], seed, dev, cfg["in_channels"])
    ref_losses, ref_first, ref_p = sysm.reference_train(cfg, w0, batches, dev, **ref_kw)
    wd = cfg["train"]["weight_decay"]
    with torch.no_grad():
        ref_g1 = {k: float(v.norm()) for k, v in ref_first.items()}
        ref_grad = {k: float((v - wd * w0[k]).norm()) for k, v in ref_first.items()}
        ref_change = {k: float((ref_p[k] - w0[k]).norm()) for k in ref_p}
    moved = [k for k in ref_change if k not in check.small_leaves(ref_grad)]
    change = check.leaf_gaps(prog_change, ref_change, moved)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses)),
        "grad_norm_gap": check.norm_gap(prog_g1, ref_g1),
        "change_norm_gap": max(change),
        "change_gap_median": statistics.median(change),
    }
