"""Served traffic (`"kind": "serve"`): requests through the program's server.

Set-up makes the weights from the seed, builds the
server (systems/<system>.py:server), makes the frame pool on the device
and copies it to the host (each request is a host array, a view of the
pool), and serves one request of every size the mix sends, so that each
bucket the window reaches is built, timed and captured before it.

Open loop: one FIFO client thread sends each request when it is due (a
sleep, then a spin over the last half millisecond) or, when the previous
one returns late, at once.  A request's latency runs from its due time to
the return of `predict`'s host array, so it holds its wait.  Every
request due in the window is served, for up to `drain_s` after it closes;
one that raises or is not served by then has failed.
Closed loop: one client sends requests back to back until the window's
seconds have passed.

`--trace 1` traces from `trace_at` of the window: a closed loop for
`trace_s` seconds; an open loop to its end, its window opened after the
first traced request (harness/trace.py), so that neither the profiler's
start nor its stop delays a request that the untraced part's readings
(`serve.queue_ms.open`) hold.

The frames of every request served over the time from the window's start
to the last return are reported as the mix's `frames_metric` (default
`serve_frames_per_s`); `serve_p95_ms`, in an open loop, is the 95th
percentile of every request's latency, a failed one counting as infinite.

The output check compares a sample drawn from the seed, with requests of
every size: in an open loop `check_per_size` requests of each size, in a
closed loop one frame of each request and then `check_frames` of those;
each frame against the reference on the same frame, by the numeric path
the server took for its request.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from perfbench.harness import check, data, traffic, weights
from perfbench.harness.trace import Tracer, span

SPIN_S = 5e-4


def _wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > SPIN_S:
            time.sleep(left - SPIN_S)


def run(ctx) -> dict:
    cell, dev, seed, sysm = ctx.cell, ctx.device, ctx.seed, ctx.system
    cfg, tr = cell.config, cell.traffic
    (h, w), ns = cfg["frame"], cfg["n_sample"]
    srv = sysm.server(cfg, weights.make(cfg["arch"], seed, dev, cfg["in_channels"]), dev,
                      **getattr(ctx, "server_kw", {}))
    ctx.stage("server built")
    pool = data.frames(tr["pool_frames"], h, w, ns, data.generator(seed, data.POOL, dev), dev)[0]
    pool = pool.cpu().numpy()
    ctx.stage("frame pool on the host")
    open_loop = tr["loop"] == "open"
    if open_loop:
        reqs = traffic.open_schedule(tr, ctx.seconds, seed)
        keep = traffic.check_sample(reqs, tr["check_per_size"], seed)
    else:
        reqs = traffic.closed_requests(tr, seed, tr["max_requests"])
        keep = set(range(len(reqs)))
    for size in sorted({r.frames for r in reqs}):  # build, time and capture what the mix reaches
        srv.predict(pool[:size])
        ctx.stage(f"first request of {size} frames")
    tracer = Tracer(dev) if ctx.trace else None
    if tracer:
        tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    served0 = dict(srv.served)
    rng = np.random.default_rng([seed, 2])
    setup_s = time.monotonic() - ctx.t_process
    log = ctx.log

    records, kept = [], {}
    trace_from = tr["trace_at"] * ctx.seconds
    traced_frames = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    for r in reqs:
        due = t0 + r.due_s
        if not open_loop and time.perf_counter() >= deadline:
            break
        if open_loop and time.perf_counter() > deadline + tr["drain_s"]:
            break
        if tracer and not tracer.active and tracer.prof is None \
                and time.perf_counter() - t0 >= trace_from:
            tracer.start(window=not open_loop)
        if open_loop:
            with span("perfbench.wait"):
                _wait_until(due)
        traced = bool(tracer and tracer.active)
        start = time.perf_counter()
        try:
            with span("perfbench.request"):
                out = srv.predict(pool[r.offset:r.offset + r.frames])
            end = time.perf_counter()
            ok = out.shape == (r.frames, h, w)
        except Exception:  # a request that raises has failed; the run goes on
            end, ok, out = time.perf_counter(), False, None
            print(traceback.format_exc(), file=sys.stderr, flush=True)
        records.append({"due": (due if open_loop else start) - t0, "start": start - t0,
                        "end": end - t0, "frames": r.frames, "ok": ok, "traced": traced})
        if ok and r.index in keep:
            j = int(rng.integers(r.frames)) if not open_loop else None
            kept[r.index] = (j, out[j].copy() if j is not None else out)
        if traced:
            if tracer.mark is None:  # an open loop's window opens after its first traced request
                tracer.open()
            else:
                traced_frames += r.frames
            if not open_loop and time.perf_counter() - t0 >= trace_from + tr["trace_s"]:
                tracer.stop(traced_frames)
    if tracer and tracer.active:
        tracer.stop(traced_frames)
    trace = tracer.finish() if tracer else None
    served = {k: v - served0.get(k, 0) for k, v in srv.served.items()}
    n_sent = len(records)
    attempted = len(reqs) if open_loop else n_sent
    failed = attempted - sum(rec["ok"] for rec in records)
    done = [rec for rec in records if rec["ok"]]
    span_s = max(rec["end"] for rec in records) if records else float("nan")
    frames_done = sum(rec["frames"] for rec in done)
    lat_ms = [(rec["end"] - rec["due"]) * 1e3 if rec["ok"] else float("inf") for rec in records]
    lat_ms += [float("inf")] * (attempted - n_sent)
    rate_name = tr.get("frames_metric", "serve_frames_per_s")
    metrics = {"setup_s": setup_s, rate_name: frames_done / span_s}
    if open_loop:
        metrics["serve_p95_ms"] = traffic.percentile(lat_ms, 95)
    log(f"# window: {n_sent} of {attempted} requests sent, {failed} failed, {frames_done} frames, "
        f"last return at {span_s:.3f} s; served frames by path {served}")
    paths = {size: sysm.serve_path(srv, size) for size in {r.frames for r in reqs}}

    # the output check, once the program's state is freed
    device_fields = ctx.device_fields()
    del srv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    by_index = {r.index: r for r in reqs}
    sample = sorted(kept)
    if not open_loop:
        sample = sorted(np.random.default_rng([seed, 3]).choice(
            sample, size=min(tr["check_frames"], len(sample)), replace=False).tolist())
    rows, served_rows, path_of = [], [], []
    for i in sample:
        r, (j, out) = by_index[i], kept[i]
        lo = r.offset + (j or 0)
        n = r.frames if j is None else 1
        rows.append(pool[lo:lo + n])
        served_rows.append(torch.from_numpy(np.asarray(out).reshape(n, h, w)))
        path_of += [paths[r.frames]] * n
    rows = np.concatenate(rows) if rows else np.zeros((0, h, w, 4), np.float32)
    numbers = compare(ctx, rows, torch.cat(served_rows) if served_rows else None, path_of)
    ok, checks = check.judge(numbers, cell.limits)
    log(f"# reference over {len(path_of)} frames in {time.perf_counter() - t_ref:.1f} s; "
        f"numbers {numbers}")
    return {
        "correct": ok and failed == 0,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_fields,
        "checks": checks,
        "readings": {"requests": records, "served": served, "trace": trace,
                     "checked": (rows, path_of), "numbers": numbers},
    }


def compare(ctx, rows, served, path_of, **ref_kw) -> dict:
    """`<path>_rel_err` of the served frames `served` [n, H, W] against the
    reference on `rows` [n, H, W, 4] (`ref_kw`: the reference's control
    switches)."""
    if not len(rows):
        return {}
    cfg, dev, seed = ctx.cell.config, ctx.device, ctx.seed
    ref_out = ctx.system.reference_serve(
        cfg, weights.make(cfg["arch"], seed, dev, cfg["in_channels"]), rows, dev, **ref_kw)
    errs = check.rel_err(served, ref_out)
    return {f"{p}_rel_err": max(e for e, q in zip(errs, path_of) if q == p)
            for p in sorted(set(path_of))}
