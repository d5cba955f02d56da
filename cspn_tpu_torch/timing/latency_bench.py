"""Serving latency of the flagship model at small batch on the card
(counterpart of scripts/latency_bench.py).

The ResNet-50 CSPN-UNet (24-step 2D CSPN, 228x304, seed-0 weights at the
init's BN statistics, bench.py:build_path_model) on three paths:

  - `bf16`: bf16 weights and convolutions, the CUDA CSPN (float32) and
    depth-to-space kernels;
  - `int8`: the same model with int8 convolutions, its weight cache built
    at load, activations quantized at every call (dynamic scales);
  - `int8_static`: the same with static activation scales calibrated at
    load on one b8 batch (build_act_calibration).

Each at b1, b8 and b32: `repeats` forwards chained (bench.py:chained), one
captured CUDA graph replayed between CUDA events, the median of `trials`
(bench.py:timed_chain).  `qcache_build_ms` is the median of 5 builds of
the int8 weight cache (utils/quant.py:build_weight_qcache), the one-off
cost at load.  The artifact is rewritten after every row.

`hybrid_policy` is derived from the rows, not timed again: DepthServer
serves a bucket below `int8_from` (its default) on bf16 and from it on
int8 (int8_static where it was measured); a bucket's latency is its
path's row, and `policy_matches_measured_best` says whether that path was
the fastest one measured at that batch.

    python -m cspn_tpu_torch.timing.latency_bench [--repeats 64] [--trials 5]
        [--device cuda|cpu] [--out result/torch_h100/latency_bench.json]
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import time

import numpy as np
import torch

from cspn_tpu_torch import resolve_device, set_conv_policy
from cspn_tpu_torch.bench import STEPS, build_path_model, chained, timed_chain
from cspn_tpu_torch.experiments import device_arg, platform_fields, write_json
from cspn_tpu_torch.serving import DepthServer
from cspn_tpu_torch.timing import default_out, log, sync

PATHS = ("bf16", "int8", "int8_static")
BATCHES = (1, 8, 32)
HW = (228, 304)
ARCH = "resnet50"
CALIB_BATCH = 8
QCACHE_BUILDS = 5
# the JAX script's artifact keys (timing/__init__.py:missing_keys)
JAX_KEYS = {
    **dict.fromkeys(("what", "note", "platform", "model", "qcache_build_ms")),
    "hybrid_policy": {"int8_from": None, "results": [dict.fromkeys((
        "batch", "path", "latency_ms", "frames_per_s", "policy_matches_measured_best"))]},
    "results": [dict.fromkeys(("path", "batch", "latency_ms", "frames_per_s"))],
}
# DepthServer's bf16 / int8 crossover (serving.py: DepthServer.__init__)
INT8_FROM = inspect.signature(DepthServer.__init__).parameters["int8_from"].default


def hybrid_policy(rows: list[dict], int8_from: int = INT8_FROM) -> dict:
    """DepthServer's per-bucket path and latency, derived from the measured
    rows (scripts/latency_bench.py:146-173): bf16 below `int8_from`, from
    it int8_static where that path was measured, else int8."""
    by = {(r["path"], r["batch"]): r for r in rows}
    paths = tuple(dict.fromkeys(r["path"] for r in rows))
    results = []
    for batch in BATCHES:
        path = ("bf16" if batch < int8_from
                else "int8_static" if ("int8_static", batch) in by else "int8")
        best = min(paths, key=lambda p: by[(p, batch)]["latency_ms"])
        results.append({
            "batch": batch,
            "path": path,
            "latency_ms": by[(path, batch)]["latency_ms"],
            "frames_per_s": by[(path, batch)]["frames_per_s"],
            "policy_matches_measured_best": path == best,
        })
    return {"int8_from": int8_from, "results": results}


def path_model(path: str, device, calib: torch.Tensor, arch: str = ARCH):
    """The path's eval-mode model: bench.py's kernel path for bf16, its int8
    path with dynamic or (int8_static) calibrated activation scales."""
    if path == "bf16":
        return build_path_model("kernel", arch, device)
    return build_path_model("int8", arch, device, calib if path == "int8_static" else None)


def qcache_build_ms(model, device, builds: int = QCACHE_BUILDS) -> float:
    """Median ms of `builds` builds of `model`'s int8 weight cache."""
    from cspn_tpu_torch.utils.quant import build_weight_qcache

    times = []
    for _ in range(builds):
        sync(device)
        t0 = time.perf_counter()
        build_weight_qcache(model)
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def run(repeats: int = 64, trials: int = 5, device=None, out: str | None = None,
        arch: str = ARCH, hw: tuple[int, int] = HW) -> dict:
    """Time every path at every batch; returns the artifact (written to
    `out` after every row when given)."""
    dev = resolve_device(device)
    set_conv_policy(dev)
    h, w = hw
    fields = platform_fields(dev)
    extras: dict = {}
    rows: list[dict] = []

    def record() -> dict:
        rec = {
            "what": "flagship serving latency at small batch on the PyTorch port: chained "
                    "forwards in one captured CUDA graph, timed by CUDA events (b128 "
                    "throughput: python -m cspn_tpu_torch bench)",
            "note": "int8 rows serve with the int8 weight cache built at load; "
                    "qcache_build_ms is the median of 5 builds of that cache. int8 quantizes "
                    "each conv's activations at every call (dynamic scales); int8_static "
                    "with scales calibrated at load on one b8 batch. hybrid_policy is derived "
                    "from these rows at DepthServer's default int8_from.",
            **fields,
            "model": f"cspn_unet_{arch}, {STEPS}-step CSPN, {h}x{w}",
            **extras,
            "results": rows,
        }
        if out:
            write_json(out, rec)
        return rec

    rng = np.random.default_rng(0)
    with torch.inference_mode():
        calib = torch.from_numpy(
            rng.standard_normal((CALIB_BATCH, h, w, 4)).astype(np.float32)).to(dev)
        for path in PATHS:
            t0 = time.perf_counter()
            model = path_model(path, dev, calib, arch)
            log(f"latency_bench: {path} model built in {time.perf_counter() - t0:.1f} s")
            if path != "bf16" and "qcache_build_ms" not in extras:
                extras["qcache_build_ms"] = round(qcache_build_ms(model, dev), 2)
                log(f"latency_bench: qcache_build_ms {extras['qcache_build_ms']}")
            for batch in BATCHES:
                x = torch.from_numpy(
                    rng.standard_normal((batch, h, w, 4)).astype(np.float32)).to(dev)
                t = timed_chain(chained(model, x, repeats), x, rng, repeats, trials)
                row = {"path": path, "batch": batch, "latency_ms": round(t * 1e3, 3),
                       "frames_per_s": round(batch / t, 1)}
                rows.append(row)
                record()
                log(f"latency_bench: {row}")
            del model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    extras["hybrid_policy"] = hybrid_policy(rows)
    return record()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.timing.latency_bench",
                                 description="serving latency at b1, b8 and b32 on the bf16, "
                                             "int8 and int8_static paths")
    ap.add_argument("--out", default=default_out("latency_bench"))
    ap.add_argument("--repeats", type=int, default=64)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rec = run(args.repeats, args.trials, device_arg(args), args.out)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
