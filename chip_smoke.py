"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives cspn_tpu_torch's main paths on the card and fails (non-zero exit) if
any phase fails:

  1. device: a CUDA card is required; prints its name and power limit, and
     turns TF32 off (the nyu_eval and nyu_train presets are float32);
  2. build: compiles every CUDA kernel from csrc/ (nvcc, sm_90a), one nvcc
     per source, all started together;
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the main paths' shapes (the backward: gradients of the plain
     version under a cotangent that is not all ones, with negative sparse
     samples), and times both with CUDA events;
  4. serving: the nyu_eval ResNet-50 CSPN-UNet (228x304, 24 steps, 8sum)
     with seeded random weights and BN statistics calibrated on one
     synthetic batch, served through DepthServer (buckets 1, 8) to requests
     of 1, 3, 8 and 11 synthetic NYU-geometry frames; checks shapes,
     finiteness, the forward kernel's launch count on that run, and
     agreement with the same server on the plain CSPN; prints metrics and
     frames/s;
  5. training: nyu_train (ResNet-50, 228x304, batch 8, 24 steps, SGD-Nesterov)
     on synthetic frames: Trainer.fit(1) (4 train steps, validation on 8
     frames) with finite metrics, moved parameters, the checkpoints, and
     both kernels' launch counts on that run; a resume into a fresh Trainer
     equal to the saved state; one train step through the kernels against
     the same step through the plain CSPN (loss and every gradient); the
     train step's forward / backward / optimizer split, frames/s and peak
     memory;
  6. stereo eval: the PSMNet + 3D-CSPN stereo model at StereoConfig width
     (max_disp 192, features 32, 24 CSPN steps) with seeded random weights
     and BN statistics calibrated on one synthetic batch, evaluated by
     StereoTrainer.run_eval over 8 synthetic 256x512 pairs at batch 4;
     checks finite disparities in [0, 191], the 3D forward kernel's launch
     count (one per batch, no backward), and agreement with the same model
     on the plain CSPN; prints the b4 forward time and frames/s with and
     without the 3D CSPN;
  7. stereo train: StereoTrainer.fit(1) (4 train steps of b4, one val
     batch) with finite loss and EPE, moved parameters, best_model written
     and reproduced by a fresh trainer's run_eval, exact 3D kernel launch
     counts; one train step through the kernels against the same step
     through the plain CSPN and the float64 oracle (phase 5's rule); the
     step's forward / backward / optimizer split, frames/s and peak memory.

Phase 3 also holds the 3D CSPN forward and backward kernels against their
plain versions at the stereo shape [4,48,64,128] (and an odd [2,5,13,17]
with C=2, and all-zero gates in a corner).  Every path's run starts with
all four kernels' launch counts at 0 and reads them at its end.

The last two lines are JSON: the kernel table, then the result line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# A train step's gradients against the float64 oracle (the same step through
# the plain CSPN in float64): each tensor within GRAD_TOL x its max, or within
# ORACLE_FACTOR x the distance of the plain float32 step from the oracle.
# After a few SGD steps at b8 the float32 gradients of some weights lie ~17%
# of their max from the float64 ones (train-mode BN amplifies rounding), and
# the kernel and plain float32 steps ~3e-3 apart: a fixed tolerance alone
# cannot tell a fault from rounding there, the plain step's own distance can.
# 8x is tests/test_torch_oracle.py's noise allowance.
GRAD_TOL = 1e-3
ORACLE_FACTOR = 8
LOSS_RTOL = 1e-5
MAIN_SHAPE = (8, 228, 304)  # N, H, W of the kernel check: bucket 8 / batch 8 at NYU geometry
STEREO_SHAPE = (4, 48, 64, 128)  # N*C, D, H, W: the stereo model's b4 quarter-resolution volume
STEREO_EVAL_FRAMES = 8
STEREO_TRAIN_FRAMES = 16  # 4 train steps of batch 4
STEPS = 24
REQUESTS = (1, 3, 8, 11)
BUCKETS = (1, 8)
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


KERNEL_NAMES = ("cspn2d_fwd", "cspn2d_bwd", "cspn3d_fwd", "cspn3d_bwd")


def reset_launches() -> None:
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_cuda

    cspn_cuda.launches = cspn_cuda.bwd_launches = 0
    cspn3d_cuda.launches = cspn3d_cuda.bwd_launches = 0


def read_launches() -> dict:
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_cuda

    return dict(zip(KERNEL_NAMES, (cspn_cuda.launches, cspn_cuda.bwd_launches,
                                   cspn3d_cuda.launches, cspn3d_cuda.bwd_launches)))


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


def cspn_inputs(gen, n, h, w, with_sparse, n_sample=500, negative=0.0):
    """Guidance, blur and (optionally) a sparse map of ~n_sample samples per
    image, a share `negative` of them negative (mask = sign = -1)."""
    guid = torch.randn(n, 8, h, w, device="cuda", generator=gen)
    blur = 1.0 + 9.0 * torch.rand(n, h, w, device="cuda", generator=gen)
    sparse = None
    if with_sparse:
        p = min(n_sample / (h * w), 1.0)
        keep = torch.rand(n, h, w, device="cuda", generator=gen) < p
        sparse = torch.where(keep, 1.0 + 9.0 * torch.rand(n, h, w, device="cuda", generator=gen), 0.0)
        flip = torch.rand(n, h, w, device="cuda", generator=gen) < negative
        sparse = torch.where(flip, -sparse, sparse)
    return guid, blur, sparse


def bound(name: str, bytes_moved: float, ops: float) -> tuple[float, str, float, float]:
    """(bound ms, 'bytes' or 'operations', bytes ms, operations ms)."""
    bw, flops = peaks(name)
    bytes_ms, ops_ms = bytes_moved / bw * 1e3, ops / flops * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", bytes_ms, ops_ms


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
    bytes_moved = 11 * n * h * w * 4  # read 8 guidance + blur + sparse, write 1
    ops = 17 * STEPS * n * h * w  # 8 FMA + the base add per pixel per step
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, bytes_moved, ops)
    log(f"  cspn2d_fwd [{n},8,{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
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
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes CSPN
    }


def plain_vjp(g_cf, b, s, ct, norm="8sum"):
    """The backward kernel's plain version: autograd of the plain forward."""
    from cspn_tpu_torch.ops import cspn_ref

    g_cf, b = g_cf.detach().requires_grad_(True), b.detach().requires_grad_(True)
    out = cspn_ref.cspn2d_reference(g_cf.movedim(1, -1), b, s, steps=STEPS, norm_type=norm)
    return torch.autograd.grad(out, (g_cf, b), ct)


def check_cspn_bwd_kernel(name: str) -> dict:
    """Phase 3: the CSPN backward kernel against autograd of the plain
    version, under a random cotangent and with negative sparse samples."""
    from cspn_tpu_torch.ops import cspn_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    n, h, w = MAIN_SHAPE
    cases = [
        ("main 8sum", (n, h, w), True, "8sum"),
        ("main 8sum_abs", (n, h, w), True, "8sum_abs"),
        ("main no-sparse", (n, h, w), False, "8sum"),
        ("odd 3x13x17", (3, 13, 17), True, "8sum"),
    ]
    max_err = 0.0
    for label, (cn, ch, cw), with_sparse, norm in cases:
        g, b, s = cspn_inputs(gen, cn, ch, cw, with_sparse, negative=0.2)
        g[0, :, :6, :6] = 0.0  # zero gates: the 0/0 guard
        ct = torch.randn(cn, ch, cw, device="cuda", generator=gen)
        gk, bk = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out = cspn_cuda.cspn2d_cuda(gk, bk, s, steps=STEPS, norm_type=norm, channel_first=True)
        got = torch.autograd.grad(out, (gk, bk), ct)
        want = plain_vjp(g, b, s, ct, norm)
        torch.cuda.synchronize()
        for what, a, x in zip(("dguidance", "dblur"), got, want):
            err = (a - x).abs().max().item()
            scale = x.abs().max().item()
            log(f"  cspn2d_bwd {label} [{cn},8,{ch},{cw}] steps={STEPS} {what}: max|err| = "
                f"{err:.3e} (max|plain| = {scale:.3e}, tol {KERNEL_TOL:g} x max|plain|)")
            if not (err <= KERNEL_TOL * scale) or not torch.isfinite(a).all():
                raise AssertionError(f"cspn2d_bwd {label} {what}: max|err| {err:.3e} > "
                                     f"{KERNEL_TOL * scale:.3e}")
            max_err = max(max_err, err)

    g, b, s = cspn_inputs(gen, n, h, w, True)
    ct = torch.randn(n, h, w, device="cuda", generator=gen)
    kernel_ms = time_ms(lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum"))
    plain_ms = time_ms(lambda: plain_vjp(g, b, s, ct))
    # read 8 guidance + blur + sparse + cotangent, write 8 + 1; operations
    # per pixel: the replay's 17 per step, the reverse step's 33, ~110 in
    # prep and epilogue
    bytes_moved = 20 * n * h * w * 4
    ops = (17 * (STEPS - 1) + 33 * STEPS + 110) * n * h * w
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, bytes_moved, ops)
    log(f"  cspn2d_bwd [{n},8,{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms, plain "
        f"(forward + autograd) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms) on {name}")
    return {
        "name": "cspn2d_bwd",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/cspn2d_bwd.cu",
        "replaces": "cspn_tpu/ops/cspn_pallas.py:1068",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this VJP
    }


def gates3d(gen, m, d, h, w, zero_corner=False):
    """Normalized 3D gates [m,26,d,h,w] from random guidance (abs, sum
    normalization with the 1e-12 guard); all-zero gates in one corner when
    asked (centre weight 1 there)."""
    g = torch.randn(m, 26, d, h, w, device="cuda", generator=gen)
    if zero_corner:
        g[0, :, :4, :6, :8] = 0.0
    a = g.abs()
    return a / a.sum(1, keepdim=True).clamp_min(1e-12)


def _check_close(label: str, got, want) -> float:
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"  {label}: max|err| = {err:.3e} (max|plain| = {scale:.3e}, tol {KERNEL_TOL:g} x max|plain|)")
    if not (err <= KERNEL_TOL * scale) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: max|err| {err:.3e} > {KERNEL_TOL * scale:.3e}")
    return err


def stereo_volume_inputs(gen, c: int):
    """(guide [2,5,13,17,26c], feat [2,5,13,17,c]) for the odd-shape case,
    with zero guidance in one corner."""
    guide = torch.randn(2, 5, 13, 17, 26 * c, device="cuda", generator=gen)
    guide[0, :2, :3, :4] = 0.0
    return guide, torch.randn(2, 5, 13, 17, c, device="cuda", generator=gen)


def check_cspn3d_kernel(name: str) -> dict:
    """Phase 3: the 3D CSPN forward kernel against its plain version."""
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    m, d, h, w = STEREO_SHAPE
    max_err = 0.0
    for label, zero_corner in (("main", False), ("main zero-gates corner", True)):
        gates = gates3d(gen, m, d, h, w, zero_corner)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        got = cspn3d_cuda.propagate3d(gates, x0, steps=STEPS)
        want = cspn_ref.propagate_nd_reference(gates, x0, STEPS)
        torch.cuda.synchronize()
        max_err = max(max_err, _check_close(f"cspn3d_fwd {label} [{m},26,{d},{h},{w}] steps={STEPS}",
                                            got, want))
    guide, feat = stereo_volume_inputs(gen, 2)
    got = cspn3d_cuda.cspn3d_cuda(guide, feat, steps=STEPS)
    want = cspn_ref.cspn_nd_reference(guide, feat, steps=STEPS)
    torch.cuda.synchronize()
    max_err = max(max_err, _check_close(f"cspn3d_fwd odd [2,5,13,17] C=2 (cspn_nd) steps={STEPS}",
                                        got, want))

    gates = gates3d(gen, m, d, h, w)
    x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
    kernel_ms = time_ms(lambda: cspn3d_cuda._launch(gates, x0, STEPS))
    plain_ms = time_ms(lambda: cspn_ref.propagate_nd_reference(gates, x0, STEPS), reps=5, warmup=1)
    voxels = m * d * h * w
    bytes_moved = 28 * voxels * 4  # read 26 gates + x0, write 1
    ops = (54 * STEPS + 26) * voxels  # 27 FMA per voxel per step, the centre sum once
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, bytes_moved, ops)
    log(f"  cspn3d_fwd [{m},26,{d},{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms) on {name}")
    return {
        "name": "cspn3d_fwd",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/cspn3d_fwd.cu",
        "replaces": "cspn_tpu/ops/cspn3d_pallas.py:69",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes a 24-step 3D CSPN
    }


def plain_vjp3d(gates, x0, ct):
    """The 3D backward kernel's plain version: autograd of the plain forward."""
    from cspn_tpu_torch.ops import cspn_ref

    gates, x0 = gates.detach().requires_grad_(True), x0.detach().requires_grad_(True)
    return torch.autograd.grad(cspn_ref.propagate_nd_reference(gates, x0, STEPS), (gates, x0), ct)


def check_cspn3d_bwd_kernel(name: str) -> dict:
    """Phase 3: the 3D CSPN backward kernel against autograd of the plain
    version, under a random cotangent."""
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    m, d, h, w = STEREO_SHAPE
    max_err = 0.0
    for label, zero_corner in (("main", False), ("main zero-gates corner", True)):
        gates = gates3d(gen, m, d, h, w, zero_corner)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        ct = torch.randn(m, d, h, w, device="cuda", generator=gen)
        gk, xk = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        got = torch.autograd.grad(cspn3d_cuda.propagate3d(gk, xk, steps=STEPS), (gk, xk), ct)
        want = plain_vjp3d(gates, x0, ct)
        torch.cuda.synchronize()
        for what, a, b in zip(("d gates", "d x0"), got, want):
            max_err = max(max_err, _check_close(
                f"cspn3d_bwd {label} [{m},26,{d},{h},{w}] steps={STEPS} {what}", a, b))
    guide, feat = stereo_volume_inputs(gen, 2)
    ct = torch.randn(feat.shape, device="cuda", generator=gen)
    grads = {}
    for label, fn in (("kernel", cspn3d_cuda.cspn3d_cuda), ("plain", cspn_ref.cspn_nd_reference)):
        g, f = guide.clone().requires_grad_(True), feat.clone().requires_grad_(True)
        grads[label] = torch.autograd.grad(fn(g, f, steps=STEPS), (g, f), ct)
    torch.cuda.synchronize()
    for what, a, b in zip(("d guide", "d feat"), grads["kernel"], grads["plain"]):
        max_err = max(max_err, _check_close(
            f"cspn3d_bwd odd [2,5,13,17] C=2 (cspn_nd) steps={STEPS} {what}", a, b))

    gates = gates3d(gen, m, d, h, w)
    x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
    ct = torch.randn(m, d, h, w, device="cuda", generator=gen)
    kernel_ms = time_ms(lambda: cspn3d_cuda._launch_bwd(gates, x0, ct, STEPS))
    plain_ms = time_ms(lambda: plain_vjp3d(gates, x0, ct), reps=5, warmup=1)
    voxels = m * d * h * w
    # read 26 gates + x0 + cotangent, write 26 + 1; per voxel 54 flops per
    # replay step, per reverse step and per step of gate cotangents, and
    # the centre and cbar sums
    bytes_moved = 55 * voxels * 4
    ops = (54 * (STEPS - 1) + 54 * STEPS + 54 * STEPS + 52) * voxels
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, bytes_moved, ops)
    log(f"  cspn3d_bwd [{m},26,{d},{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms, plain "
        f"(forward + autograd) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"(bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms) on {name}")
    return {
        "name": "cspn3d_bwd",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/cspn3d_bwd.cu",
        "replaces": "cspn_tpu/ops/cspn3d_pallas.py:291",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this VJP
    }


def serve_slice(name: str) -> dict:
    """Phase 4: the nyu_eval model served through DepthServer; returns each
    CSPN kernel's launches during the served requests."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
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
    reset_launches()
    t0 = time.perf_counter()
    outs = [srv.predict(r) for r in reqs]  # predict returns host arrays: synchronized
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    expected = dict.fromkeys(KERNEL_NAMES, 0)
    expected["cspn2d_fwd"] = sum(len(chunk_plan(n, BUCKETS)) for n in REQUESTS)
    log(f"  served requests {REQUESTS} over buckets {BUCKETS}: {sum(REQUESTS)} frames in "
        f"{elapsed:.4f} s = {sum(REQUESTS) / elapsed:.2f} frames/s on {name}; "
        f"launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"served run launched {launches}, expected {expected}")
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


def _train_cfg(save_dir: str, backend: str = "auto"):
    """nyu_train on the synthetic dataset at NYU geometry."""
    from cspn_tpu_torch.config import PRESETS
    from cspn_tpu_torch.utils.profiling import NYU_HW

    cfg = PRESETS["nyu_train"]
    return dataclasses.replace(
        cfg, save_dir=save_dir, best_model_dir=save_dir, log_every=1,
        model=dataclasses.replace(cfg.model, cspn_backend=backend),
        data=dataclasses.replace(cfg.data, dataset="synthetic", crop_hw=NYU_HW))


def _same_state(a, b) -> None:
    """Raise unless two Trainers' model and optimizer states are equal."""
    for k, v in a.state.model.state_dict().items():
        if not torch.equal(v, b.state.model.state_dict()[k]):
            raise AssertionError(f"resumed model differs at {k}")
    sa, sb = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    if sa["param_groups"] != sb["param_groups"] or sa["state"].keys() != sb["state"].keys():
        raise AssertionError("resumed optimizer param groups or state keys differ")
    for i, st in sa["state"].items():
        if not torch.equal(st["momentum_buffer"], sb["state"][i]["momentum_buffer"]):
            raise AssertionError(f"resumed momentum buffer {i} differs")


def check_against_oracle(kernel, plain, oracle) -> None:
    """Raise unless a train step through the kernels agrees with the same
    step through the plain CSPN (loss within LOSS_RTOL) and each gradient
    lies within GRAD_TOL x its max of the float64 oracle's, or within
    ORACLE_FACTOR x the plain float32 step's own distance from it.  Each
    argument is (loss, {name: gradient})."""
    (loss_k, grads_k), (loss_r, grads_r), (_, grads_64) = kernel, plain, oracle
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    # per tensor: |kernel - f64| within GRAD_TOL of max|f64|, or within
    # ORACLE_FACTOR x the plain float32 step's own |plain - f64|
    worst = {"kernel vs plain": ("", 0.0), "kernel vs f64": ("", 0.0),
             "plain vs f64": ("", 0.0), "kernel/plain distance to f64": ("", 0.0)}
    failed = []
    for k, g64 in grads_64.items():
        scale = g64.abs().max().item()
        d_kp = (grads_k[k] - grads_r[k]).abs().max().item()
        d_k = (grads_k[k].double() - g64).abs().max().item()
        d_r = (grads_r[k].double() - g64).abs().max().item()
        sc = max(scale, 1e-300)
        for what, v in (("kernel vs plain", d_kp / sc), ("kernel vs f64", d_k / sc),
                        ("plain vs f64", d_r / sc),
                        ("kernel/plain distance to f64", d_k / max(d_r, 1e-300))):
            if v > worst[what][1]:
                worst[what] = (k, v)
        if not (d_k <= GRAD_TOL * scale or d_k <= ORACLE_FACTOR * d_r):
            failed.append(f"{k}: |kernel - f64| {d_k:.3e}, |plain - f64| {d_r:.3e}, max {scale:.3e}")
    log(f"  one train step, kernel vs plain CSPN (deterministic cuDNN): loss {loss_k:.6f} vs "
        f"{loss_r:.6f} (rel {loss_rel:.2e}, tol {LOSS_RTOL:g})")
    for what, (k, v) in worst.items():
        log(f"    worst {what}: {v:.3e} ({k}){' of max|f64 grad|' if 'distance' not in what else ''}")
    if not (np.isfinite(loss_k) and loss_rel <= LOSS_RTOL):
        raise AssertionError(f"kernel-step loss {loss_k} differs from the plain step's by {loss_rel:.2e}")
    if failed:
        raise AssertionError(f"kernel-step gradients off the float64 oracle (tol {GRAD_TOL:g} x max "
                             f"or {ORACLE_FACTOR} x the plain step's distance): " + "; ".join(failed[:5]))
    log(f"  every gradient within {GRAD_TOL:g} x max|f64| of the float64 oracle or within "
        f"{ORACLE_FACTOR} x the plain float32 step's own distance from it")


def train_slice(name: str, kernel_ms: dict) -> dict:
    """Phase 5: nyu_train through Trainer.fit(1) on the card; returns each
    CSPN kernel's launches during the fit."""
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.factory import build_loaders
    from cspn_tpu_torch.train.loop import Trainer, make_train_step
    from cspn_tpu_torch.train.loss import masked_l1_loss
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.utils.profiling import train_step_split_ms

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as save_dir:
        cfg = _train_cfg(save_dir)
        h, w = cfg.data.crop_hw
        log(f"  model {cfg.model.arch}, cspn steps {cfg.model.cspn_steps}, norm "
            f"{cfg.model.cspn_norm_type}, {cfg.data.n_sample} sparse samples, {h}x{w}, batch "
            f"{cfg.data.batch_size_train}, SGD lr {cfg.optim.lr} momentum {cfg.optim.momentum} "
            f"nesterov {cfg.optim.nesterov} wd {cfg.optim.weight_decay}, loss {cfg.optim.loss}")
        t0 = time.perf_counter()
        trainer = Trainer(cfg, *build_loaders(cfg), device="cuda")
        n_train, n_val = len(trainer.train_loader), len(trainer.val_loader)
        p0 = {k: v.detach().clone() for k, v in trainer.state.model.named_parameters()}
        log(f"  built the Trainer in {time.perf_counter() - t0:.1f} s")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        val = trainer.fit(1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=n_train + n_val,
                        cspn2d_bwd=n_train)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"  Trainer.fit(1): {n_train} train steps of {cfg.data.batch_size_train}, {n_val} val "
            f"batches of {cfg.data.batch_size_eval} in {elapsed:.2f} s (checkpoints included); "
            f"launches {launches} (expected {expected}); peak device memory {peak_gib:.2f} GiB")
        if launches != expected:
            raise AssertionError(f"training launched {launches}, expected {expected}")
        with open(os.path.join(save_dir, "log_train.txt")) as f:
            train_row = [float(v) for v in f.read().splitlines()[-1].split()]
        if not (np.isfinite(train_row).all() and all(np.isfinite(v) for v in val.values())):
            raise AssertionError(f"non-finite metrics: train {train_row}, val {val}")
        moved = sum(not torch.equal(p, p0[k]) for k, p in trainer.state.model.named_parameters())
        if moved != len(p0):
            raise AssertionError(f"only {moved} of {len(p0)} parameter tensors moved")
        if not (trainer.ckpt.has("best_model") and trainer.ckpt.has("epoch_00")):
            raise AssertionError(f"checkpoints missing in {os.listdir(save_dir)}")
        log(f"  train MAE {train_row[5]:.4f} RMSE {train_row[4]:.4f}; val MAE {val['MAE']:.4f} RMSE "
            f"{val['RMSE']:.4f}; all {len(p0)} parameter tensors moved; best_model and epoch_00 "
            "written")
        del p0

        fresh = Trainer(cfg, *build_loaders(cfg), device="cuda")
        fresh.resume("best_model")
        _same_state(trainer, fresh)
        log(f"  resumed a fresh Trainer from best_model: epoch {fresh.epoch}, step "
            f"{fresh.state.step}; parameters, BN statistics and momentum equal")
        del fresh

    # one train step through the kernels, through the plain CSPN, and through
    # the plain CSPN in float64 (the oracle), from the same weights on the
    # same batch, with deterministic cuDNN: the two float32 steps differ only
    # in the CSPN.  Each pixel's ground truth lies 1 to 2 above or below its
    # prediction (random side), so no L1 derivative flips its sign under
    # rounding, and the cotangent keeps random signs as in training.
    model_k = trainer.state.model
    del trainer
    frames = [build_loaders(cfg)[0].dataset[i] for i in range(cfg.data.batch_size_train)]
    x = torch.from_numpy(np.stack([f["rgbd"] for f in frames])).cuda()
    models = {"kernel": model_k}
    for label, dtype in (("plain", torch.float32), ("float64", torch.float64)):
        models[label] = build_model(_train_cfg(""), train=True, device="cuda", seed=None).to(dtype)
        models[label].cspn_backend = "reference"
        models[label].load_state_dict(model_k.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            pred = model_k(x)
        side = torch.where(torch.rand(pred.shape, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
        depth = pred + side * (1.0 + torch.rand(pred.shape, device="cuda", generator=gen))
        for label, model in models.items():
            dt = next(model.parameters()).dtype
            step = make_train_step(model, make_optimizer(model.parameters()))
            loss, _ = step(x.to(dt), depth.to(dt))
            results[label] = (loss.item(), {k: p.grad for k, p in model.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = False
    check_against_oracle(*(results[k] for k in models))
    del models, results

    split = train_step_split_ms(model_k, make_optimizer(model_k.parameters()), masked_l1_loss,
                                x, depth)
    n = x.shape[0]
    cspn_share = (kernel_ms["cspn2d_fwd"] + kernel_ms["cspn2d_bwd"]) / split["step"]
    log(f"  train step (batch {n}, median of 5, CUDA events): {split['step']:.3f} ms = "
        f"{n * 1e3 / split['step']:.2f} frames/s; forward + loss {split['forward']:.3f} ms, "
        f"backward {split['backward']:.3f} ms, optimizer {split['optimizer']:.3f} ms; the two CSPN "
        f"kernels {100 * cspn_share:.2f}% of the step (their phase-3 times); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {name}")
    return launches


def _stereo_loaders(cfg, n_train: int, n_val: int):
    """Synthetic 256x512 stereo loaders at the config's batch size."""
    from cspn_tpu_torch.data import DataLoader, SyntheticStereoDataset
    from cspn_tpu_torch.utils.profiling import STEREO_HW

    train = DataLoader(SyntheticStereoDataset(n_train, STEREO_HW, cfg.max_disp, seed=0),
                       cfg.batch_size, shuffle=True, drop_last=True)
    val = DataLoader(SyntheticStereoDataset(n_val, STEREO_HW, cfg.max_disp, seed=1), cfg.batch_size)
    return train, val


def _stereo_model_line(cfg) -> str:
    from cspn_tpu_torch.utils.profiling import STEREO_HW

    return (f"  PSMNetCSPN max_disp {cfg.max_disp}, features {cfg.features}, {cfg.cspn_steps} CSPN "
            f"steps, {STEREO_HW[0]}x{STEREO_HW[1]}, batch {cfg.batch_size}, {cfg.dtype}")


def stereo_eval_slice(name: str) -> dict:
    """Phase 6: the stereo model evaluated through StereoTrainer.run_eval;
    returns each kernel's launches during run_eval."""
    from cspn_tpu_torch.train.evaluate import calibrate_bn_stats
    from cspn_tpu_torch.train.stereo_loop import (
        StereoConfig,
        StereoTrainer,
        build_stereo_model,
        make_stereo_eval_step,
    )
    from cspn_tpu_torch.utils.profiling import stereo_batch

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as save_dir:
        cfg = StereoConfig(save_dir=save_dir)
        _, val = _stereo_loaders(cfg, 0, STEREO_EVAL_FRAMES)
        log(_stereo_model_line(cfg))
        t0 = time.perf_counter()
        trainer = StereoTrainer(cfg, val, val, device="cuda")
        model = calibrate_bn_stats(trainer.model, *stereo_batch(cfg, cfg.batch_size, seed=0)[:2])
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  built + calibrated {n_params / 1e6:.3f} M params in {time.perf_counter() - t0:.1f} s")

        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        metrics = trainer.run_eval("best_model")  # none in a fresh save_dir: the calibrated weights
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn3d_fwd=len(val))
        log(f"  run_eval over {STEREO_EVAL_FRAMES} pairs in {len(val)} batches: {elapsed:.3f} s = "
            f"{STEREO_EVAL_FRAMES / elapsed:.2f} frames/s on {name}; launches {launches} "
            f"(expected {expected})")
        if launches != expected:
            raise AssertionError(f"stereo eval launched {launches}, expected {expected}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite stereo metrics {metrics}")

    model.eval()
    model_ref = build_stereo_model(cfg, device="cuda", seed=None, cspn_backend="reference")
    model_ref.load_state_dict(model.state_dict())
    step_k = make_stereo_eval_step(model, cfg.max_disp)
    step_r = make_stereo_eval_step(model_ref, cfg.max_disp)
    worst = 0.0
    for batch in val:
        left, right, disp = (torch.from_numpy(batch[k]).cuda() for k in ("left", "right", "disp"))
        pred, ref = step_k(left, right, disp)[0], step_r(left, right, disp)[0]
        # softmax regression lies in [0, max_disp - 1]; 1e-3 of rounding slack
        if (pred.shape != disp.shape or not torch.isfinite(pred).all()
                or pred.min().item() < -1e-3 or pred.max().item() > cfg.max_disp - 1 + 1e-3):
            raise AssertionError(f"bad disparities: shape {tuple(pred.shape)}, range "
                                 f"[{pred.min().item()}, {pred.max().item()}]")
        err, scale = (pred - ref).abs().max().item(), ref.abs().max().item()
        if not err <= KERNEL_TOL * scale:
            raise AssertionError(f"stereo output vs plain-CSPN model: {err:.3e} > "
                                 f"{KERNEL_TOL * scale:.3e}")
        worst = max(worst, err / scale)
    log(f"  disparities finite, in [0, {cfg.max_disp - 1}]; max|kernel - plain| / max|plain| = "
        f"{worst:.3e}; EPE {metrics['EPE']:.4f}, 3px {metrics['3px']:.4f}, D1 {metrics['D1']:.4f} "
        "vs synthetic ground truth (random weights)")
    del model_ref

    model_nc = build_stereo_model(dataclasses.replace(cfg, use_cspn=False), device="cuda", seed=None)
    model_nc.load_state_dict(model.state_dict(), strict=False)  # all but the guidance head
    model_nc.eval()
    left, right, _ = stereo_batch(cfg, cfg.batch_size, seed=1)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for label, mdl in (("with the 3D CSPN", model), ("without (use_cspn=False)", model_nc)):
            fwd_ms = time_ms(lambda: mdl(left, right), reps=5, warmup=1)
            log(f"  b{cfg.batch_size} forward {label}: {fwd_ms:.3f} ms = "
                f"{cfg.batch_size * 1e3 / fwd_ms:.2f} frames/s on {name}")
    log(f"  peak device memory of the forwards {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def stereo_train_slice(name: str, kernel_ms: dict) -> dict:
    """Phase 7: the stereo model trained through StereoTrainer.fit(1);
    returns each kernel's launches during the fit."""
    from cspn_tpu_torch.models.stereo import smooth_l1_disparity_loss
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.train.stereo_loop import (
        StereoConfig,
        StereoTrainer,
        build_stereo_model,
        make_stereo_train_step,
    )
    from cspn_tpu_torch.utils.profiling import stereo_batch, train_step_split_ms

    def optimizer(model):
        return make_optimizer(model.parameters(), cfg.lr, momentum=0.9, weight_decay=1e-4,
                              nesterov=False)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as save_dir:
        cfg = StereoConfig(save_dir=save_dir)
        train, val = _stereo_loaders(cfg, STEREO_TRAIN_FRAMES, cfg.batch_size)
        log(_stereo_model_line(cfg) + f", SGD lr {cfg.lr} momentum 0.9 wd 1e-4, smooth-L1")
        trainer = StereoTrainer(cfg, train, val, device="cuda")
        n_train, n_val = len(train), len(val)
        p0 = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
        losses = []
        train_epoch = trainer.train_epoch
        trainer.train_epoch = lambda epoch: losses.append(train_epoch(epoch)) or losses[-1]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        val_metrics = trainer.fit(1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn3d_fwd=n_train + n_val,
                        cspn3d_bwd=n_train)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"  StereoTrainer.fit(1): {n_train} train steps of {cfg.batch_size}, {n_val} val batch in "
            f"{elapsed:.2f} s (checkpoint included); launches {launches} (expected {expected}); "
            f"peak device memory {peak_gib:.2f} GiB")
        if launches != expected:
            raise AssertionError(f"stereo training launched {launches}, expected {expected}")
        if not (np.isfinite(losses).all() and all(np.isfinite(v) for v in val_metrics.values())):
            raise AssertionError(f"non-finite: train loss {losses}, val {val_metrics}")
        moved = sum(not torch.equal(p, p0[k]) for k, p in trainer.model.named_parameters())
        if moved != len(p0):
            raise AssertionError(f"only {moved} of {len(p0)} parameter tensors moved")
        if not trainer.ckpt.has("best_model"):
            raise AssertionError(f"best_model missing in {os.listdir(save_dir)}")
        del p0
        fresh = StereoTrainer(cfg, train, val, device="cuda", seed=1)  # another init: restore matters
        again = fresh.run_eval("best_model")
        rel = abs(again["EPE"] - val_metrics["EPE"]) / abs(val_metrics["EPE"])
        log(f"  train loss {losses[0]:.4f}; val EPE {val_metrics['EPE']:.4f} 3px "
            f"{val_metrics['3px']:.4f} D1 {val_metrics['D1']:.4f}; all {moved} parameter tensors "
            f"moved; a fresh trainer's run_eval('best_model') EPE {again['EPE']:.6f} (rel {rel:.1e})")
        if not rel <= LOSS_RTOL:
            raise AssertionError(f"best_model EPE {again['EPE']} != validated {val_metrics['EPE']}")
        del fresh

    # one train step through the kernels, through the plain CSPN, and through
    # the plain CSPN in float64 (the oracle), from the same weights on the
    # same batch, with deterministic cuDNN (phase 5's rule; the smooth-L1
    # derivative is continuous, so rounding flips no sign)
    model_k = trainer.model
    del trainer
    left, right, disp = stereo_batch(cfg, cfg.batch_size, seed=0)
    models = {"kernel": model_k}
    for label, dtype in (("plain", torch.float32), ("float64", torch.float64)):
        models[label] = build_stereo_model(cfg, train=True, device="cuda", seed=None,
                                           cspn_backend="reference").to(dtype)
        models[label].load_state_dict(model_k.state_dict())
    results = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, model in models.items():
            dt = next(model.parameters()).dtype
            step = make_stereo_train_step(model, optimizer(model), cfg.max_disp)
            loss, _ = step(left.to(dt), right.to(dt), disp.to(dt))
            results[label] = (loss.item(), {k: p.grad for k, p in model.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = False
    check_against_oracle(*(results[k] for k in models))
    del models, results

    def loss_fn(out, d):
        return smooth_l1_disparity_loss(out, d, cfg.max_disp)

    torch.cuda.reset_peak_memory_stats()
    split = train_step_split_ms(model_k, optimizer(model_k), loss_fn, (left, right), disp)
    n = left.shape[0]
    cspn_share = (kernel_ms["cspn3d_fwd"] + kernel_ms["cspn3d_bwd"]) / split["step"]
    log(f"  stereo train step (batch {n}, median of 5, CUDA events): {split['step']:.3f} ms = "
        f"{n * 1e3 / split['step']:.2f} frames/s; forward + loss {split['forward']:.3f} ms, "
        f"backward {split['backward']:.3f} ms, optimizer {split['optimizer']:.3f} ms; the two 3D "
        f"CSPN kernels {100 * cspn_share:.2f}% of the step (their phase-3 times); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {name}")
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
    log(f"[1/7] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    _build.build()
    log(f"[2/7] built {sorted(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")

    log("[3/7] kernels against their plain versions")
    rows = [check_cspn_kernel(name), check_cspn_bwd_kernel(name), check_cspn3d_kernel(name),
            check_cspn3d_bwd_kernel(name)]
    kernel_ms = {r["name"]: r["ms"] for r in rows}

    log("[4/7] nyu_eval served through DepthServer")
    by_path = {"serve": serve_slice(name)}

    log("[5/7] nyu_train trained through Trainer.fit")
    by_path["train"] = train_slice(name, kernel_ms)

    log("[6/7] stereo (PSMNet + 3D CSPN) evaluated through StereoTrainer.run_eval")
    by_path["stereo_eval"] = stereo_eval_slice(name)

    log("[7/7] stereo (PSMNet + 3D CSPN) trained through StereoTrainer.fit")
    by_path["stereo_train"] = stereo_train_slice(name, kernel_ms)

    for r in rows:  # launches on the main paths' runs
        r["launches_by_path"] = {path: counts[r["name"]] for path, counts in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was launched on no path")
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
