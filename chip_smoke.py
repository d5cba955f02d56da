"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives cspn_tpu_torch's main path on the card and fails (non-zero exit) if
any phase fails:

  1. device: a CUDA card is required; prints its name and power limit, and
     turns TF32 off (the nyu_eval preset is float32);
  2. build: compiles every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the main path's shapes, and times both with CUDA events;
  4. the slice: the nyu_eval ResNet-50 CSPN-UNet (228x304, 24 steps, 8sum)
     with seeded random weights and BN statistics calibrated on one
     synthetic batch, served through DepthServer (buckets 1, 8) to requests
     of 1, 3, 8 and 11 synthetic NYU-geometry frames; checks shapes,
     finiteness, the kernel's launch count on that run, and agreement with
     the same server on the plain CSPN; prints metrics and frames/s.

The last two lines are JSON: the kernel table, then the result line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# (name substring, memory bytes/s, f32 non-tensor-core FLOP/s): NVIDIA's data
# sheets, dense rates at the full power limit; first match wins
_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)
KERNEL_TOL = 1e-4  # x max|plain|: FMA contraction and summation order differ
MAIN_SHAPE = (8, 228, 304)  # N, H, W of the kernel check: bucket 8 at NYU geometry
STEPS = 24
REQUESTS = (1, 3, 8, 11)
BUCKETS = (1, 8)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def peaks(name: str) -> tuple[float, float]:
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no published peak rates for {name!r}")


def time_ms(fn, reps: int = 21, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cspn_inputs(gen, n, h, w, with_sparse, n_sample=500):
    guid = torch.randn(n, 8, h, w, device="cuda", generator=gen)
    blur = 1.0 + 9.0 * torch.rand(n, h, w, device="cuda", generator=gen)
    sparse = None
    if with_sparse:
        p = min(n_sample / (h * w), 1.0)
        keep = torch.rand(n, h, w, device="cuda", generator=gen) < p
        sparse = torch.where(keep, 1.0 + 9.0 * torch.rand(n, h, w, device="cuda", generator=gen), 0.0)
    return guid, blur, sparse


def check_cspn_kernel(name: str) -> dict:
    """Phase 3: the CSPN kernel against its plain version on the card."""
    from cspn_tpu_torch.ops import cspn_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w = MAIN_SHAPE
    cases = [
        ("main 8sum", (n, h, w), True, "8sum"),
        ("main 8sum_abs", (n, h, w), True, "8sum_abs"),
        ("main no-sparse", (n, h, w), False, "8sum"),
        ("odd 3x13x17", (3, 13, 17), True, "8sum"),
    ]
    max_err = 0.0
    for label, (cn, ch, cw), with_sparse, norm in cases:
        g, b, s = cspn_inputs(gen, cn, ch, cw, with_sparse)
        got = cspn_cuda.cspn2d_cuda(g, b, s, steps=STEPS, norm_type=norm, channel_first=True)
        want = cspn_ref.cspn2d_reference(g.movedim(1, -1), b, s, steps=STEPS, norm_type=norm)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"  cspn2d_fwd {label} [{cn},8,{ch},{cw}] steps={STEPS}: max|err| = {err:.3e} "
            f"(max|plain| = {scale:.3e}, tol {KERNEL_TOL:g} x max|plain|)")
        if not (err <= KERNEL_TOL * scale) or not torch.isfinite(got).all():
            raise AssertionError(f"cspn2d_fwd {label}: max|err| {err:.3e} > {KERNEL_TOL * scale:.3e}")
        max_err = max(max_err, err)

    g, b, s = cspn_inputs(gen, n, h, w, True)
    kernel_ms = time_ms(lambda: cspn_cuda.cspn2d_cuda(g, b, s, steps=STEPS, channel_first=True))
    g_last = g.movedim(1, -1)
    plain_ms = time_ms(lambda: cspn_ref.cspn2d_reference(g_last, b, s, steps=STEPS))
    bw, flops = peaks(name)
    bytes_moved = 11 * n * h * w * 4  # read 8 guidance + blur + sparse, write 1
    ops = 17 * STEPS * n * h * w  # 8 FMA + the base add per pixel per step
    bytes_ms, ops_ms = bytes_moved / bw * 1e3, ops / flops * 1e3
    log(f"  cspn2d_fwd [{n},8,{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"(bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms) on {name}")
    return {
        "name": "cspn2d_fwd",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/cspn2d_fwd.cu",
        "replaces": "cspn_tpu/ops/cspn_pallas.py:107",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes CSPN
    }


def serve_slice(name: str) -> int:
    """Phase 4: the nyu_eval model served through DepthServer; returns the
    CSPN kernel's launches during the served requests."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.ops import cspn_cuda
    from cspn_tpu_torch.serving import DepthServer, chunk_plan
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.metrics import ErrorAverager, evaluate_error
    from cspn_tpu_torch.utils.profiling import calibrated_model, nyu_eval_synthetic

    cfg = nyu_eval_synthetic()
    h, w = cfg.data.crop_hw
    log(f"  model {cfg.model.arch}, cspn steps {cfg.model.cspn_steps}, "
        f"norm {cfg.model.cspn_norm_type}, {cfg.data.n_sample} sparse samples, {h}x{w}")
    t0 = time.perf_counter()
    model = calibrated_model(cfg)
    ref_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_backend="reference"))
    model_ref = build_model(ref_cfg, train=False, device="cuda", seed=None)
    model_ref.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  built + calibrated {n_params / 1e6:.1f} M params in {time.perf_counter() - t0:.1f} s")

    srv, srv_ref = DepthServer(model, BUCKETS), DepthServer(model_ref, BUCKETS)
    srv.warmup(h, w)
    srv_ref.warmup(h, w)
    ds = SyntheticDepthDataset(length=sum(REQUESTS), hw=(h, w), n_sample=cfg.data.n_sample,
                               seed=1, split="val")
    frames = [ds[i] for i in range(len(ds))]
    starts = np.cumsum((0,) + REQUESTS)
    reqs = [np.stack([f["rgbd"] for f in frames[a:b]]) for a, b in zip(starts, starts[1:])]
    gts = [np.stack([f["depth"] for f in frames[a:b]]) for a, b in zip(starts, starts[1:])]

    torch.cuda.synchronize()
    cspn_cuda.launches = 0
    t0 = time.perf_counter()
    outs = [srv.predict(r) for r in reqs]  # predict returns host arrays: synchronized
    elapsed = time.perf_counter() - t0
    launches = cspn_cuda.launches
    expected = sum(len(chunk_plan(n, BUCKETS)) for n in REQUESTS)
    log(f"  served requests {REQUESTS} over buckets {BUCKETS}: {sum(REQUESTS)} frames in "
        f"{elapsed:.4f} s = {sum(REQUESTS) / elapsed:.2f} frames/s on {name}; "
        f"cspn2d_fwd launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"cspn2d_fwd launched {launches} times, expected {expected}")
    if srv.served["float32"] != sum(REQUESTS):
        raise AssertionError(f"served counter {srv.served} != {sum(REQUESTS)}")

    avg = ErrorAverager()
    worst = 0.0
    for req, out, gt in zip(reqs, outs, gts):
        if out.shape != req.shape[:3] or not np.isfinite(out).all():
            raise AssertionError(f"bad output: shape {out.shape}, finite {np.isfinite(out).all()}")
        ref = srv_ref.predict(req)
        err = float(np.abs(out - ref).max())
        tol = KERNEL_TOL * float(np.abs(ref).max())
        if not err <= tol:
            raise AssertionError(f"served output vs plain-CSPN server: {err:.3e} > {tol:.3e}")
        worst = max(worst, err / max(float(np.abs(ref).max()), 1e-30))
        error = evaluate_error(torch.from_numpy(gt), torch.from_numpy(out))
        avg.update({k: float(v) for k, v in error.items()}, len(req))
    log(f"  outputs finite, shapes right; max|kernel - plain| / max|plain| = {worst:.3e}")
    with torch.inference_mode():
        for b in BUCKETS:
            x = torch.from_numpy(np.stack([f["rgbd"] for f in frames[:b]])).cuda()
            fwd_ms = time_ms(lambda: model(x), reps=5, warmup=1)
            log(f"  bucket {b} forward: {fwd_ms:.3f} ms = {b * 1e3 / fwd_ms:.2f} frames/s on {name}")
    m = avg.average
    log("  metrics vs synthetic ground truth (random weights): " + ", ".join(
        f"{k}={m[k]:.4f}" for k in ("RMSE", "MAE", "ABS_REL", "LG10", "DELTA1.25", "iRMSE")))
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from cspn_tpu_torch.ops import _build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[1/4] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    _build.build()
    log(f"[2/4] built {sorted(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")

    log("[3/4] kernels against their plain versions")
    row = check_cspn_kernel(name)

    log("[4/4] nyu_eval served through DepthServer")
    row["launches"] = serve_slice(name)

    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
