"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --routes-of CHECKOUT   # only the CSPN, probe and depth-to-space kernels' timing
    python3 chip_smoke.py --routes-of CHECKOUT --d2s-only   # only the depth-to-space stages
    python3 chip_smoke.py --steps-of CHECKOUT    # only the train steps and served frames/s

With --routes-of it only times the 2D CSPN kernels, the sharded
segment's, the probe's, the paddle kernel and the depth-to-space stages of
the cspn_tpu_torch in CHECKOUT (time_fwd_routes, time_halo_seg_routes,
time_probe_and_paddle, time_d2s_routes; "." for this one), and with
--steps-of the paths'
train steps and served frames/s (steps_of), so that one harness times two
trees in turns.  Without arguments it drives cspn_tpu_torch's main
paths on the card and fails (non-zero exit) if any phase fails:

  1. device: a CUDA card is required; prints its name and power limit and
     sets the entry points' default conv policy (set_conv_policy: cuDNN's
     algorithm timing, TF32 off) before the first convolution;
  2. build: compiles every CUDA kernel from csrc/ (nvcc, sm_90a), one nvcc
     per source, all started together;
  3. kernels: holds each kernel against its plain PyTorch version on the card
     at the main paths' shapes (the backward: gradients of the plain
     version under a cotangent that is not all ones, with negative sparse
     samples), and times both with CUDA events;
  4. serving: the nyu_eval ResNet-50 CSPN-UNet (228x304, 24 steps, 8sum,
     the subpixel decoder) with seeded random weights and BN statistics
     calibrated on one synthetic batch, served through DepthServer
     (buckets 1, 8) to requests of 1, 3, 8 and 11 synthetic NYU-geometry
     frames; checks shapes, finiteness, the CSPN and depth-to-space
     kernels' launch counts on that run, and agreement with the same
     server on the plain CSPN; prints metrics and frames/s; times the b8
     forward in both decoder forms with the same weights and holds their
     outputs together.  The server replays one captured CUDA graph a
     bucket (serving.py): its outputs equal the same model's eager server
     bit for bit, each replay counts one forward's launches, which
     torch.profiler's device records confirm, and each bucket's forward
     (CUDA events) and served frames/s (host clock) are timed graphed and
     eager in turns, with the graphs' memory (check_graphed);
  5. training: nyu_train (ResNet-50, 228x304, batch 8, 24 steps, SGD-Nesterov,
     the subpixel decoder) on synthetic frames: Trainer.fit(1) (4 train
     steps, validation on 8 frames) with finite metrics, moved parameters,
     the checkpoints, and the CSPN and depth-to-space kernels' launch
     counts on that run; a resume into a fresh Trainer equal to the saved
     state; one train step through the kernels against the same step
     through the plain CSPN (loss and every gradient); the train step's
     forward / backward / optimizer split in both decoder forms, frames/s
     and peak memory; then `--debug-nans` (utils/profiling.py:debug_nans)
     over a b8 step that stays finite and one on a NaN input that raises
     FloatingPointError (debug_nans_slice);
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
     step's forward / backward / optimizer split, frames/s and peak memory;
  8. kitti serve: kitti_benchmark (ResNet-18, 352x1216, 24 steps) served
     through DepthServer (buckets 1, 4) to requests of 1, 3, 5 frames,
     against the same server on the plain CSPN, with exact launch counts;
  9. kitti train: Trainer.fit(1) (4 steps of b4, validation at b1), exact
     launch counts, one b4 train step against the plain CSPN and float64;
 10. the `demo` subcommand for dims 2 and 3, and the step-body probe;
 11. the spatially sharded CSPN on in-process meshes (parallel/): the op
     cspn2d_spatial at KITTI b4 over S = 2 and 4 rows blocks, both norms,
     with and without sparse, against cspn2d forward and backward; the
     KITTI CSPN-UNet with spatial_mesh (S = 2) against the unsharded model
     (eval b1 and b4, one b4 train step by phase 5's rule) and the stereo
     model with D over S = 2 (one b4 train step); sharded and unsharded
     timed; exact segment-kernel launches and halo exchanges;
 12. data-parallel training (parallel/data.py): nyu_train's b8 step through
     DistributedDataParallel on a 1-rank NCCL group in this process, on the
     sync-BN route (float32 reduce) and the bf16 route, against the
     unwrapped step, the float64 oracle and bf16 rounding; the reduce
     hook's bytes per dtype; the steps timed in turns with peak memory; and
     `bench-scaling --mode train`'s one point (ddp_slice);
 13. precision: nyu_eval (buckets 1, 8, 32) and kitti_benchmark (1, 4)
     served through load_server on the bf16 and int8 paths, with dynamic
     and static activation scales: warmup peaks, launches and per-path
     counters, every request's output against a plain twin's (the same
     models on the plain 2D CSPN and depth-to-space), each bucket's
     depth-to-space calls bit for bit against the plain versions, frames/s
     and both paths' forwards per bucket, rel-norms against float32, and
     each path's graphed buckets against the eager server as in phase 4; and
     the bf16 nyu_train b8 and stereo b4 steps against their plain twins
     and the float64 oracle, timed beside float32 (precision_serve,
     precision_train);
 14. deployment: a reference-format checkpoint of the calibrated nyu_eval
     model (`module.` prefixes, the keys the reference builds but never
     calls) imported and exported with a symbolic batch at float32 (the
     `export --check` subcommand), bf16 and int8 with static scales
     (export.py); each graph holds the `cspn2d_tiled` op once and `d2s` 9
     times; each artifact served in this process and reloaded in a fresh
     one at b = 1, 3 and 8 against the eager model, with exact launches;
     export and save times, sizes, eager and exported b1/b8 forwards; then
     `eval --import-torch-checkpoint --dump-images` and `infer --out-dir`
     on a few frames, the PNGs read back with zlib (deployment_slice);
 15. the file datasets (files_slice): the host library's png_unfilter
     against its plain version under all five PNG filters; 40 NYU pairs at
     480x640 and 20 KITTI pairs at 375x1242 written as PNGs (16-bit depth:
     millimetres, metres x 256 with 7% valid) with their manifests (and
     `make-manifest`'s list checked against them); the samples' shapes,
     sparse channel and Bernoulli counts, seeded val splits equal; decode
     and aug_pack ms a frame, the loader's ms a batch drained alone at 1
     and 4 threads and 4 spawned processes (whose batches equal the
     threads'; one pool of the same 4 workers over 2 epochs, the second
     epoch's first batch timed beside the first's); nyu_train's Trainer.fit(1) (4 steps of b8, 8 val frames)
     and kitti_benchmark's (4 steps of b4, 4 val frames at b1) from the
     files with exact launches and each step's wait in the loader beside
     its time, nyu_eval's run_eval (5 runs) on the trained weights, one
     nyu_mono b8 step, the `eval` subcommand on the KITTI files; neither
     PIL nor h5py imported, and every sample on the host library's route;
 16. the `bench` subcommand in a subprocess (bench.py: nyu_eval frames/s at
     b128 on the kernel, int8 and plain reference paths, each timed as one
     captured CUDA graph of 8 chained forwards): exit code 0 and one JSON
     line with metric, value > 0, unit and vs_baseline (bench_slice).
Phases 4 and 8 also time DepthServer over SERVE_WINDOW requests.

Phase 3 also holds the 3D CSPN forward and backward kernels against their
plain versions at the stereo shape [4,48,64,128] (and an odd [2,5,13,17]
with C=2, all-zero gates in a corner, and the sharded stereo path's
segment: its S = 2 blocks stacked, D / 2 + 2K deep, K steps), the states
a training forward keeps for the backward too, and the backward run twice
on them bit for bit; it times both at every path's shape (stereo b4,
demo3d, the sharded segment; cspn3d_path_shapes), counts their CUDA
launches per call with torch.profiler and holds them to 1 forward, 2
backward, splits the backward's two kernels, fits the forward's device
time as fixed + per volume-step (through 4 and 24 steps) beside the same
slope on a grid with one warp of work a block (BARRIER_SHAPE: the grid
barrier and a step's latency), and fits the sharded segment's per
voxel-step cost (choose_halo's 3D constant); the same on bf16 gates
(check_cspn3d_bf16_gates), timed beside float32; and the
depth-to-space kernel
and its adjoint (`d2s`, `s2d`) bit for bit at the b8 decoder's five
shapes, an odd one with C=1, unaligned rows of 19 and 38 values, and in
float64 and bfloat16, in both forms (one [N, 4C, h, w] tensor, and the four
phase convs' outputs the decoder hands over from 128 features), timed
beside torch.cat + the kernel and torch.cat + F.pixel_shuffle, with
layer2's phase convs + depth-to-space profiled in both forms
(profile_phase_stage); it holds the 2D
CSPN's two forwards (the tiled one, and cspn2d_fwd, which keeps its
states for the backward) and the backward at both norms, with and without
sparse, at NYU b8, an odd shape, KITTI b4 and a ragged shape, and at their
edges (1-row and 1-column maps, sides no multiple of the tile, 1, 7, 9 and
24 steps): the two forwards equal value for value, every kept state
within tolerance of the plain forward's, the backward on the kept states
equal to its replay and to a second run bit for bit; it counts their CUDA
launches a call with torch.profiler and holds them to
ops/cspn_cuda.py:cuda_launches_per_call; it times both 2D CSPN forwards,
the backward on both routes and both ways to run a train step's 2D CSPN
at the paths' shapes (FWD_ROUTE_SHAPES; the times ops/cspn_cuda.py:use_tiled
is set from); and the sharded CSPN's segment kernels (`cspn2d_halo_seg`
in both its routes, the one that keeps its states for the backward and
the one that does not, and its backward on those states) against the
plain segment on the inputs cspn2d_spatial hands them at every shape, K
and keep of the paths that run them (phase 11's op and models;
halo_seg_cases): the two routes equal value for value, every kept state
within tolerance of the plain segment's, the backward to plain autograd
and to a second run bit for bit; timed at the b4 train step's, their CUDA
launches counted by torch.profiler, with the cost model's constants
(parallel/halo.py:choose_halo); the probe and the paddle kernel also as
queued calls.  Every path's run starts with all eleven
kernels' launch counts at 0 and reads them at its end.

The last two lines are JSON: the kernel table, then the result line.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import importlib.util
import inspect
import itertools
import json
import os
import re
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
# a 3D volume that gives the sweep a full grid with one warp of work a block
# (132 blocks of 4 x 32 voxels on an H100): its per-step slope is the grid
# barrier and one step's latency
BARRIER_SHAPE = (1, 4, 33, 128)
# the depth-to-space calls of a b8 nyu_eval forward (ResNet-50, 228x304):
# (stage, input [N, 4C, H, W], crop, calls per forward); layers 1-4 run it
# for conv1 and sc_conv1, the fused 9-channel head once
D2S_STAGES = (
    ("layer1", (8, 4096, 8, 10), (15, 19), 2),
    ("layer2", (8, 2048, 15, 19), (29, 38), 2),
    ("layer3", (8, 1024, 29, 38), (57, 76), 2),
    ("layer4", (8, 256, 57, 76), (114, 152), 2),
    ("head", (8, 36, 114, 152), (228, 304), 1),
)
REQUESTS = (1, 3, 8, 11)
BUCKETS = (1, 8)
SERVE_WINDOW = 120  # requests of a served-rate window, cycling through a path's requests
# phase 13 (precision): nyu_eval's buckets and requests (1 on bf16; 5 and 8 on
# bucket 8, 20 and 32 on bucket 32, int8 from 8, the JAX package's default),
# kitti_benchmark's (its buckets stop at 4, so int8 from 4 there, to run both
# paths), and the frames of a bucket's served-rate window
PRECISION_BUCKETS, PRECISION_REQUESTS, PRECISION_INT8_FROM = (1, 8, 32), (1, 5, 8, 20, 32), 8
KITTI_PRECISION_REQUESTS, KITTI_INT8_FROM = (1, 3, 4), 4
PRECISION_WINDOW = 128
# phase 13's served outputs against the plain twin's (the plain 2D CSPN and
# depth-to-space on the same bf16 / int8 models and cuDNN algorithms), x
# max|plain|: half a bf16 ulp, the rounding of a bf16 output (the 2D CSPN's
# float32 kernel and plain version differ by 1e-4 at most, KERNEL_TOL)
PRECISION_TWIN_TOL = 2.0**-8
KITTI_SHAPE = (4, 352, 1216)  # N, H, W: kitti_benchmark's training batch
KITTI_RAGGED = (2, 75, 101)  # ragged last tiles in both axes, several tiles each way
# the 2D CSPN's shapes on the main paths (N, H, W): NYU buckets 1 and 8
# (b8 trains), KITTI b1 (eval, bucket 1) and b4 (train, bucket 4); the
# forward kernels and the train-step pairs are timed at each
# (ops/cspn_cuda.py:use_tiled is set from these times)
FWD_ROUTE_SHAPES = ((1, 228, 304), (8, 228, 304), (1, 352, 1216), (4, 352, 1216))
KITTI_REQUESTS = (1, 3, 5)
KITTI_BUCKETS = (1, 4)
KITTI_TRAIN_FRAMES = 16  # 4 train steps of batch 4
KITTI_VAL_FRAMES = 4  # validation at batch 1
# paddle 2D: (N, H, W, C): the demo's --dim-num 2 maps, and four NYU frames with C=2
PADDLE_CASES = ((3, 64, 128, 1), (4, 228, 304, 2))
DEMO_ITERS = 3
PROBE_CHECK_ITERS = 4
PROBE_ROW_ITERS = 64  # iterations of the probe's timed row (kernel, plain)
PROBE_TRIALS = 7  # the probe path's slope trials (step_probe.run_probe)
# bf16 state: the kernel's bf16 FMA rounds once where the plain version may
# round twice; 4 iterations of ~1-sized values stay within a few bf16 ulps
PROBE_TOL = {torch.float32: KERNEL_TOL, torch.bfloat16: 1e-2}
# the sharded 2D CSPN: the op is held at S = 2 and 4 row blocks with the
# cost model's K and K = 8 (three segments), the models at S = 2
HALO_K = 8
SPATIAL = (2, 4)
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


KERNEL_NAMES = ("cspn2d_fwd", "cspn2d_bwd", "cspn3d_fwd", "cspn3d_bwd", "d2s", "s2d",
                "cspn2d_tiled", "paddle2d", "step_probe", "cspn2d_halo_seg",
                "cspn2d_halo_seg_bwd")


def reset_launches() -> None:
    """Every kernel's launch count and the sharded CSPN's exchange count to 0."""
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_cuda, cspn_halo_cuda, cspn_paddle2d_cuda, d2s
    from cspn_tpu_torch.parallel import halo
    from cspn_tpu_torch.utils import step_probe

    cspn_cuda.launches = cspn_cuda.bwd_launches = cspn_cuda.tiled_launches = 0
    cspn3d_cuda.launches = cspn3d_cuda.bwd_launches = 0
    d2s.launches = d2s.bwd_launches = 0
    cspn_paddle2d_cuda.launches = step_probe.launches = 0
    cspn_halo_cuda.launches = cspn_halo_cuda.bwd_launches = halo.exchanges = 0


def read_launches() -> dict:
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_cuda, cspn_halo_cuda, cspn_paddle2d_cuda, d2s
    from cspn_tpu_torch.utils import step_probe

    return dict(zip(KERNEL_NAMES, (cspn_cuda.launches, cspn_cuda.bwd_launches,
                                   cspn3d_cuda.launches, cspn3d_cuda.bwd_launches,
                                   d2s.launches, d2s.bwd_launches, cspn_cuda.tiled_launches,
                                   cspn_paddle2d_cuda.launches, step_probe.launches,
                                   cspn_halo_cuda.launches, cspn_halo_cuda.bwd_launches)))


def d2s_per_forward(model) -> int:
    """depth_to_space2 calls in one CSPNUNet forward: one per
    SubpixelUnpoolConv the decoder blocks call, and one for the fused
    9-channel head, which uses the two heads' weights but not their modules."""
    from cspn_tpu_torch.models.decoder import SubpixelUnpoolConv

    fused = model.use_cspn
    heads = ("gud_up_proj_layer5", "gud_up_proj_layer6")
    calls = sum(isinstance(m, SubpixelUnpoolConv) for name, m in model.named_modules()
                if not (fused and name.startswith(heads)))
    return calls + int(fused and model.subpixel)


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


def time_queued_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Median device time of one call among `calls` back-to-back calls.
    The stream first sleeps ~5 ms on the card (torch.cuda._sleep), so the
    host has enqueued every call before the card reaches the first: the
    events time the card alone, not the host's launch overhead, which
    exceeds the device time of a call of tens of microseconds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)  # cycles: ~5 ms at the H100's ~2 GHz
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
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


def plain_states(g_cf, b, s, steps, norm):
    """x_1..x_{steps-1} of the plain forward (cspn2d_reference run t steps
    for each t), stacked [steps-1, N, H, W]: the states a training forward
    keeps for the backward."""
    from cspn_tpu_torch.ops import cspn_ref

    g_last = g_cf.movedim(1, -1)
    return torch.stack([cspn_ref.cspn2d_reference(g_last, b, s, steps=t, norm_type=norm)
                        for t in range(1, steps)]) if steps > 1 else b.new_empty((0, *b.shape))


def check_states(label: str, states, g_cf, b, s, steps, norm, quiet: bool = False) -> float:
    """Every kept state x_t against the plain forward's x_t, each within
    KERNEL_TOL x max|plain x_t|; returns the largest error."""
    want = plain_states(g_cf, b, s, steps, norm)
    if states.shape != want.shape:
        raise AssertionError(f"{label}: states {tuple(states.shape)}, expected {tuple(want.shape)}")
    return max((_check_close(f"{label} x_{t + 1}", states[t], want[t], quiet=True)
                for t in range(len(want))), default=0.0)


def check_cspn_kernel(name: str) -> dict:
    """Phase 3: cspn2d_fwd, the forward that keeps its states (the train
    paths' forward), against its plain version on the card: the output and
    every kept state x_1..x_{T-1} within KERNEL_TOL, the output equal to
    the tiled forward's value for value; timed at NYU b8 beside the
    function's bound (11 planes: the inputs and the output) and the bound
    of all it writes (42 planes: also the states and the folded gates),
    its CUDA launches a call counted by torch.profiler."""
    from cspn_tpu_torch.ops import cspn_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w = MAIN_SHAPE
    cases = [
        ("main 8sum", (n, h, w), True, "8sum"),
        ("main 8sum_abs", (n, h, w), True, "8sum_abs"),
        ("main no-sparse", (n, h, w), False, "8sum"),
        ("odd 3x13x17", (3, 13, 17), True, "8sum"),
        ("kitti b4", KITTI_SHAPE, True, "8sum"),
    ]
    max_err = 0.0
    for label, (cn, ch, cw), with_sparse, norm in cases:
        g, b, s = cspn_inputs(gen, cn, ch, cw, with_sparse, negative=0.2)
        got, _, states = cspn_cuda._launch(g, b, s, STEPS, norm)
        tiled = cspn_cuda._launch_tiled(g, b, s, STEPS, norm)
        want = cspn_ref.cspn2d_reference(g.movedim(1, -1), b, s, steps=STEPS, norm_type=norm)
        torch.cuda.synchronize()
        err = _check_close(f"cspn2d_fwd {label} [{cn},8,{ch},{cw}] steps={STEPS}", got, want)
        if not torch.equal(got, tiled):
            raise AssertionError(f"cspn2d_fwd {label}: values differ from the tiled forward's")
        err = max(err, check_states(f"cspn2d_fwd {label}", states, g, b, s, STEPS, norm))
        log(f"  cspn2d_fwd {label}: the output equals the tiled forward's, the {STEPS - 1} kept "
            f"states within tol, max|err| {err:.3e}")
        max_err = max(max_err, err)
        del got, states, tiled, want

    g, b, s = cspn_inputs(gen, n, h, w, True)
    kernel_ms = time_ms(lambda: cspn_cuda._launch(g, b, s, STEPS, "8sum"))
    counted, found = launches_per_call(
        lambda: cspn_cuda._launch(g, b, s, STEPS, "8sum"), CSPN2D_KERNELS,
        cspn_cuda.cuda_launches_per_call(STEPS)["cspn2d_fwd"], "cspn2d_fwd at NYU b8")
    g_last = g.movedim(1, -1)
    plain_ms = time_ms(lambda: cspn_ref.cspn2d_reference(g_last, b, s, steps=STEPS))
    # the function: read 8 guidance + blur + sparse, write out
    ops = 17 * STEPS * n * h * w  # 8 FMA + the base add per pixel per step
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, 11 * n * h * w * 4, ops)
    # what this kernel also writes: the STEPS - 1 states and 8 folded gates
    kept_planes = 11 + STEPS - 1 + 8
    kept_bound_ms = bound(name, kept_planes * n * h * w * 4, ops)[0]
    log(f"  cspn2d_fwd [{n},8,{h},{w}] steps={STEPS} keeping its states: kernel {kernel_ms:.4f} ms "
        f"({counted} CUDA launches a call, by torch.profiler {found}), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms: 11 planes; operations {ops_ms:.4f} "
        f"ms), with the states and folded gates it writes ({kept_planes} planes) "
        f"{kept_bound_ms:.4f} ms on {name}")
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
        "kept_bound_ms": kept_bound_ms,  # also the states and folded gates it writes
        "cuda_launches_per_call": counted,  # counted by torch.profiler in this run
    }


def plain_vjp(g_cf, b, s, ct, norm="8sum", steps=STEPS):
    """The backward kernel's plain version: autograd of the plain forward."""
    from cspn_tpu_torch.ops import cspn_ref

    g_cf, b = g_cf.detach().requires_grad_(True), b.detach().requires_grad_(True)
    out = cspn_ref.cspn2d_reference(g_cf.movedim(1, -1), b, s, steps=steps, norm_type=norm)
    return torch.autograd.grad(out, (g_cf, b), ct)


# the 2D CSPN kernels' cases (label, (N, H, W), with sparse, norm): both
# norms, with and without sparse, at NYU b8 (MAIN_SHAPE), an odd shape,
# kitti_benchmark's training batch and a ragged shape; the tiled forward and
# the backward are each held at every one
CSPN2D_CASES = tuple(
    (f"{label} {norm}{'' if sparse else ' no-sparse'}", shape, sparse, norm)
    for label, shape in (("main", MAIN_SHAPE), ("odd 3x13x17", (3, 13, 17)),
                         ("kitti b4", KITTI_SHAPE), ("ragged", KITTI_RAGGED))
    for norm in ("8sum", "8sum_abs") for sparse in (True, False))
# the tiled forward's further cases: the served buckets CSPN2D_CASES lacks
# (NYU bucket 1 of phases 4 and 13, bucket 32 of phase 13, KITTI bucket 1),
# with sparse
TILED_SERVED_CASES = tuple(
    (f"{label} {norm}", shape, True, norm)
    for label, shape in (("nyu bucket 1", (1, 228, 304)), ("nyu bucket 32", (32, 228, 304)),
                         ("kitti bucket 1", (1, 352, 1216)))
    for norm in ("8sum", "8sum_abs"))
# the tile kernels' edges: 1-row and 1-column maps, sides no multiple of the
# tile (ops/cspn_cuda.py:TILE), every launch split of `steps`
CSPN2D_EDGE_SHAPES = ((2, 1, 300), (2, 300, 1), (3, 97, 145))
CSPN2D_EDGE_STEPS = (1, 7, 9, 24)


def cspn2d_bwd_routes(g, b, s, ct, norm, steps=STEPS):
    """The backward kernel on both routes: on the states cspn2d_fwd kept,
    twice, and replaying them; fails unless the three are bit for bit the
    same.  Returns the kept route's (d guidance, d blur)."""
    from cspn_tpu_torch.ops import cspn_cuda

    kept = cspn_cuda._launch(g, b, s, steps, norm)[1:]
    first = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm, kept)
    second = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm, kept)
    replayed = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, x) for a, x in zip(first, second)):
        raise AssertionError("cspn2d_bwd: a second backward on the same states differs")
    if not all(torch.equal(a, x) for a, x in zip(first, replayed)):
        raise AssertionError("cspn2d_bwd: the kept states give other values than the replay")
    return first


def bwd_floors(name: str, n: int, h: int, w: int) -> tuple[float, str, float]:
    """cspn2d_bwd's byte floors at [n,8,h,w] and STEPS steps: the function's
    (20 planes: 8 guidance, blur, sparse, cotangent read, 8 + 1 written; the
    replay route's) as (bound ms, bound by), and the kept-states route's (the
    23 states x_1..x_{T-1} read too) in ms.  Operations per pixel: the
    replay's 17 a step, the reverse step's 33, ~110 in prep and epilogue."""
    ops = (17 * (STEPS - 1) + 33 * STEPS + 110) * n * h * w
    bound_ms, bound_by, _, _ = bound(name, 20 * n * h * w * 4, ops)
    kept_ms = bound(name, (20 + STEPS - 1) * n * h * w * 4, ops)[0]
    return bound_ms, bound_by, kept_ms


def check_2d_edges(name: str) -> float:
    """Phase 3: the tile kernels at their edges (CSPN2D_EDGE_SHAPES x
    CSPN2D_EDGE_STEPS, the norms and sparse in turn): the tiled forward
    equal to cspn2d_fwd value for value and within KERNEL_TOL of the plain
    version, cspn2d_fwd's kept states within KERNEL_TOL of the plain
    forward's, the backward on both routes bit for bit the same
    (cspn2d_bwd_routes) and within KERNEL_TOL of autograd of the plain
    version.  Returns the largest error."""
    from cspn_tpu_torch.ops import cspn_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(10)
    max_err = 0.0
    for i, ((n, h, w), steps) in enumerate(itertools.product(CSPN2D_EDGE_SHAPES,
                                                              CSPN2D_EDGE_STEPS)):
        norm, with_sparse = ("8sum", "8sum_abs")[i % 2], i % 3 != 2
        g, b, s = cspn_inputs(gen, n, h, w, with_sparse, n_sample=max(h * w // 50, 1), negative=0.2)
        g[0, :, :5, :5] = 0.0  # zero gates: the 0/0 guard
        ct = torch.randn(n, h, w, device="cuda", generator=gen)
        label = f"[{n},8,{h},{w}] steps={steps} {norm}{'' if with_sparse else ' no-sparse'}"
        got = cspn_cuda._launch_tiled(g, b, s, steps, norm)
        kept, _, states = cspn_cuda._launch(g, b, s, steps, norm)
        want = cspn_ref.cspn2d_reference(g.movedim(1, -1), b, s, steps=steps, norm_type=norm)
        torch.cuda.synchronize()
        if not torch.equal(got, kept):
            raise AssertionError(f"cspn2d_tiled {label}: values differ from cspn2d_fwd's")
        max_err = max(max_err, _check_close(f"cspn2d_tiled edge {label}", got, want, quiet=True),
                      check_states(f"cspn2d_fwd edge {label}", states, g, b, s, steps, norm,
                                   quiet=True))
        grads = cspn2d_bwd_routes(g, b, s, ct, norm, steps)
        for what, a, x in zip(("dguidance", "dblur"), grads, plain_vjp(g, b, s, ct, norm, steps)):
            max_err = max(max_err, _check_close(f"cspn2d_bwd edge {label} {what}", a, x,
                                                quiet=True))
    log(f"  cspn2d_tiled, cspn2d_fwd and cspn2d_bwd at "
        f"{len(CSPN2D_EDGE_SHAPES) * len(CSPN2D_EDGE_STEPS)} edge cases {CSPN2D_EDGE_SHAPES} x "
        f"steps {CSPN2D_EDGE_STEPS}: the forwards equal, every kept state within tol, both routes "
        f"of the backward bit for bit the same, max|err| "
        f"{max_err:.3e} (tol {KERNEL_TOL:g} x max|plain|)")
    return max_err


def check_cspn_bwd_kernel(name: str) -> dict:
    """Phase 3: the CSPN backward kernel against autograd of the plain
    version, under a random cotangent and with negative sparse samples, at
    every CSPN2D_CASES case: through autograd (cspn2d_fwd keeps its
    states), and on both routes (cspn2d_bwd_routes: twice on the kept
    states, replaying them), bit for bit the same; then timed at NYU b8 on
    both routes beside each route's byte floor, its CUDA launches a call
    counted by torch.profiler."""
    from cspn_tpu_torch.ops import cspn_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    n, h, w = MAIN_SHAPE
    max_err = 0.0
    for label, (cn, ch, cw), with_sparse, norm in CSPN2D_CASES:
        g, b, s = cspn_inputs(gen, cn, ch, cw, with_sparse, negative=0.2)
        g[0, :, :6, :6] = 0.0  # zero gates: the 0/0 guard
        ct = torch.randn(cn, ch, cw, device="cuda", generator=gen)
        gk, bk = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out = cspn_cuda.cspn2d_cuda(gk, bk, s, steps=STEPS, norm_type=norm, channel_first=True)
        got = torch.autograd.grad(out, (gk, bk), ct)
        routes = cspn2d_bwd_routes(g, b, s, ct, norm)
        want = plain_vjp(g, b, s, ct, norm)
        if not all(torch.equal(a, r) for a, r in zip(got, routes)):
            raise AssertionError(f"cspn2d_bwd {label}: autograd gives other values than the kernel")
        for what, a, x in zip(("dguidance", "dblur"), got, want):
            max_err = max(max_err, _check_close(
                f"cspn2d_bwd {label} [{cn},8,{ch},{cw}] steps={STEPS} {what}", a, x))

    g, b, s = cspn_inputs(gen, n, h, w, True)
    ct = torch.randn(n, h, w, device="cuda", generator=gen)
    kept = cspn_cuda._launch(g, b, s, STEPS, "8sum")[1:]
    kept_ms = time_ms(lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum", kept))
    replay_ms = time_ms(lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum"))
    plain_ms = time_ms(lambda: plain_vjp(g, b, s, ct))
    want = cspn_cuda.cuda_launches_per_call(STEPS)
    counted, split = {}, {}
    for route, fn in (("kept", lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum", kept)),
                      ("replay", lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum"))):
        counted[route], found = launches_per_call(fn, CSPN2D_KERNELS, want[f"cspn2d_bwd_{route}"],
                                                  f"cspn2d_bwd {route} at NYU b8")
        split[route] = {k: v["ms"] for k, v in found.items()}
    bound_ms, bound_by, kept_bound_ms = bwd_floors(name, n, h, w)
    log(f"  cspn2d_bwd [{n},8,{h},{w}] steps={STEPS}: on the forward's kept states {kept_ms:.4f} ms "
        f"({counted['kept']} CUDA launches a call, by torch.profiler {split['kept']}), replaying "
        f"them {replay_ms:.4f} ms ({counted['replay']} CUDA launches); plain (forward + autograd) "
        f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: 20 planes, the replay route's "
        f"floor), the kept route's floor {kept_bound_ms:.4f} ms (20 + {STEPS - 1} state planes) "
        f"on {name}")
    return {
        "name": "cspn2d_bwd",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/cspn2d_bwd.cu",
        "replaces": "cspn_tpu/ops/cspn_pallas.py:1068",
        "launches": None,
        "max_abs_err": max(max_err, check_2d_edges(name)),
        "ms": kept_ms,  # the paths' route: on cspn2d_fwd's kept states
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this VJP
        "replay_ms": replay_ms,  # the replay first, as without kept states
        "kept_bound_ms": kept_bound_ms,
        "cuda_launches_per_call": counted,  # counted by torch.profiler in this run
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


def _check_close(label: str, got, want, quiet: bool = False) -> float:
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not quiet:
        log(f"  {label}: max|err| = {err:.3e} (max|plain| = {scale:.3e}, tol {KERNEL_TOL:g} x "
            "max|plain|)")
    if not (err <= KERNEL_TOL * scale) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: max|err| {err:.3e} > {KERNEL_TOL * scale:.3e}")
    return err


def stereo_volume_inputs(gen, c: int):
    """(guide [2,5,13,17,26c], feat [2,5,13,17,c]) for the odd-shape case,
    with zero guidance in one corner."""
    guide = torch.randn(2, 5, 13, 17, 26 * c, device="cuda", generator=gen)
    guide[0, :2, :3, :4] = 0.0
    return guide, torch.randn(2, 5, 13, 17, c, device="cuda", generator=gen)


def stereo_segment():
    """The sharded stereo path's 3D segment (phase 11): the S = 2 blocks of
    the b4 volume stacked along the batch, each D / 2 + 2K deep, K steps
    (the cost model's K); returns ((M, D_ext, H, W), K)."""
    from cspn_tpu_torch.parallel import halo

    m, d, h, w = STEREO_SHAPE
    k = halo.effective_halo(None, STEPS, d // 2, h * w, m, n_gate_planes=26,
                            t_step=halo.T3D_STEP_S_PER_VOX)
    return (2 * m, d // 2 + 2 * k, h, w), k


def cspn3d_cases():
    """(label, (M, D, H, W), steps, zero-gates corner) of the 3D kernels'
    checks: the stereo volume, and the sharded stereo path's segment."""
    seg_shape, k = stereo_segment()
    return (("main", STEREO_SHAPE, STEPS, False), ("main zero-gates corner", STEREO_SHAPE, STEPS, True),
            (f"sharded segment (S=2, K={k})", seg_shape, k, False))


def cspn3d_path_shapes():
    """(path, (M, D, H, W), steps) of every path that runs the 3D kernels:
    the stereo b4 volume (stereo_eval, stereo_train), the demo's
    (demo3d) and the sharded stereo segment (stereo_sharded) at its K."""
    seg_shape, k = stereo_segment()
    return (("stereo b4", STEREO_SHAPE, STEPS), ("demo3d", (3, 48, 64, 128), STEPS),
            (f"stereo_sharded segment (K={k})", seg_shape, k))


def cspn3d_step_fit(shape, lo: int = 4, hi: int = STEPS) -> tuple[float, float]:
    """The forward's device time as fixed + steps x per-step cost, fitted
    through `lo` and `hi` steps (CUDA events, median of 21 each).  Returns
    (fixed ms: the launch and the load of the gates, per volume-step us:
    one step's work and one grid barrier)."""
    from cspn_tpu_torch.ops import cspn3d_cuda

    gen = torch.Generator(device="cuda").manual_seed(5)
    m, d, h, w = shape
    gates, x0 = gates3d(gen, m, d, h, w), torch.randn(shape, device="cuda", generator=gen)
    t_hi, t_lo = (time_ms(lambda: cspn3d_cuda._launch(gates, x0, n)) for n in (hi, lo))
    per_step_ms = (t_hi - t_lo) / (hi - lo)
    return t_lo - lo * per_step_ms, per_step_ms * 1e3 / m


CSPN3D_KERNELS = ("cspn3d_fwd_sweep_kernel", "cspn3d_adj_sweep_kernel", "cspn3d_gate_grad_kernel")
# the 2D CSPN kernels' CUDA names (csrc/cspn2d_*.cu): the forward keeping its
# states, the tiled forward, the backward's replay, reverse tiles and
# epilogue; the sharded segment's backward: its replay, reverse tiles and
# keep epilogue
CSPN2D_KERNELS = ("cspn2d_fwd_kernel", "cspn2d_tiled_kernel", "replay_tile_kernel",
                  "reverse_tile_kernel", "epilogue_kernel")
HALO_SEG_BWD_KERNELS = ("halo_seg_reverse_kernel", "keep_epilogue_kernel")
# the segment kernels' K at their launch splits (12 steps a launch)
SEG_BWD_SPLITS = (1, 11, 12, 13)


def kernel_profile(fn, keys, reps: int = 5) -> tuple[float, dict]:
    """One call of `fn` under torch.profiler, averaged over `reps` calls:
    the kernel launches the host made (its cudaLaunch* calls), and for
    each kernel whose name holds one of `keys` its launches and device ms
    as the card's activity records give them.  Every kernel the card
    records must be one of `keys`'.  The card's records can miss the
    kernels that ran first in a session, the host's launch records do not
    (utils/profiler_records.py measures both; PERF.md): so the host's
    count is the one to hold."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # CUPTI allocates its activity buffers on the card: give back what the
    # caching allocator holds unused, or after phase 3's large plain
    # autograd graphs a session can come back without device events
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    host, found = 0.0, {}
    for e in prof.key_averages():
        if e.key.startswith(("cudaLaunch", "cuLaunch")):
            host += e.count / reps
            continue
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith(("Memcpy", "Memset")):
            continue
        key = next((key for key in keys if key in e.key), None)
        if key is None:
            raise AssertionError(f"a kernel outside {keys} ran: {e.key}")
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        k = found.setdefault(key, {"launches": 0.0, "ms": 0.0})
        k["launches"] += e.count / reps
        k["ms"] += us / 1e3 / reps
    return host, found


def launches_per_call(fn, keys, want: int, what: str) -> tuple[int, dict]:
    """The CUDA launches of one call of `fn` (kernel_profile: the host's),
    held to `want` (ops/cspn3d_cuda.py, ops/cspn_cuda.py:
    cuda_launches_per_call; ops/cspn_halo_cuda.py:cuda_launches)."""
    counted, found = kernel_profile(fn, keys)
    recorded = sum(k["launches"] for k in found.values())
    if counted != want:
        free, total = torch.cuda.mem_get_info()
        raise AssertionError(f"{what}: {counted} CUDA launches a call, expected {want}: the card "
                             f"recorded {found} ({free / 2**30:.1f} of {total / 2**30:.1f} GiB of "
                             "device memory free)")
    if recorded != counted:
        log(f"  {what}: the card's records hold {recorded} of the {counted} launches a call")
    return int(counted), found


def check_cspn3d_kernel(name: str) -> dict:
    """Phase 3: the 3D CSPN forward kernel against its plain version, and
    its times at every path's shape."""
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_ref
    from cspn_tpu_torch.parallel import halo

    gen = torch.Generator(device="cuda").manual_seed(3)
    max_err = 0.0
    for label, (m, d, h, w), steps, zero_corner in cspn3d_cases():
        gates = gates3d(gen, m, d, h, w, zero_corner)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        got = cspn3d_cuda.propagate3d(gates, x0, steps=steps)
        want = cspn_ref.propagate_nd_reference(gates, x0, steps)
        torch.cuda.synchronize()
        max_err = max(max_err, _check_close(f"cspn3d_fwd {label} [{m},26,{d},{h},{w}] steps={steps}",
                                            got, want))
        # the states a training forward keeps for the backward
        out, states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)
        want_states = [x0]
        for _ in range(steps - 1):
            want_states.append(cspn_ref.propagate_nd_reference(gates, want_states[-1], 1))
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            raise AssertionError(f"cspn3d_fwd {label}: keeping the states changed the output")
        if steps > 1:
            max_err = max(max_err, _check_close(f"cspn3d_fwd {label} kept states x_1..x_{steps - 1}",
                                                states, torch.stack(want_states[1:])))
    guide, feat = stereo_volume_inputs(gen, 2)
    got = cspn3d_cuda.cspn3d_cuda(guide, feat, steps=STEPS)
    want = cspn_ref.cspn_nd_reference(guide, feat, steps=STEPS)
    torch.cuda.synchronize()
    max_err = max(max_err, _check_close(f"cspn3d_fwd odd [2,5,13,17] C=2 (cspn_nd) steps={STEPS}",
                                        got, want))

    by_shape = {}
    for label, (m, d, h, w), steps in cspn3d_path_shapes():
        gates = gates3d(gen, m, d, h, w)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        plan = cspn3d_cuda.device_plan(gates.device, d, h, w)
        # without states (eval, serving): two state buffers in turn; kept
        # (training): x_1..x_{T-1} written for the backward
        ms = time_ms(lambda: cspn3d_cuda._launch(gates, x0, steps))
        kept = time_ms(lambda: cspn3d_cuda._launch(gates, x0, steps, keep_states=True))
        by_shape[label] = {"shape": [m, 26, d, h, w], "steps": steps, "ms": ms, "kept_states_ms": kept}
        log(f"  cspn3d_fwd {label} [{m},26,{d},{h},{w}] steps={steps}: {ms:.4f} ms, keeping its "
            f"states {kept:.4f} ms; {plan.blocks} blocks of {cspn3d_cuda.SLAB}x{plan.cols} voxels, "
            f"gate planes {plan.n_smem} in shared memory, {plan.n_l2} from L2 on {name}")
    m, d, h, w = STEREO_SHAPE
    gates = gates3d(gen, m, d, h, w)
    x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
    kernel_ms, kept_ms = by_shape["stereo b4"]["ms"], by_shape["stereo b4"]["kept_states_ms"]
    plain_ms = time_ms(lambda: cspn_ref.propagate_nd_reference(gates, x0, STEPS), reps=5, warmup=1)
    fwd_launches, _ = launches_per_call(lambda: cspn3d_cuda._launch(gates, x0, STEPS),
                                        CSPN3D_KERNELS, cspn3d_cuda.cuda_launches_per_call(STEPS)[0],
                                        "cspn3d_fwd at the stereo b4 volume")
    fixed_ms, step_us = cspn3d_step_fit(STEREO_SHAPE)
    # a full grid with one warp of work a block: the barrier and a step's latency
    barrier_us = cspn3d_step_fit(BARRIER_SHAPE)[1]
    # choose_halo's 3D terms on the sharded stereo segment: per voxel-step
    # (T3D_STEP_S_PER_VOX) and the segment's fixed cost beside the model's
    # reload of 26 + 3 planes
    seg_shape, k = stereo_segment()
    seg_fixed_ms, seg_us = cspn3d_step_fit(seg_shape)
    seg_voxels = seg_shape[1] * seg_shape[2] * seg_shape[3]
    seg_ps = seg_us * 1e6 / seg_voxels
    reload_ms = 29 * seg_shape[0] * seg_voxels * 4 / halo.HBM_BPS * 1e3
    log(f"  cspn3d_fwd sharded segment {list(seg_shape)} (K={k}): fitted through 4 and {STEPS} steps "
        f"{seg_fixed_ms:.4f} ms fixed (the model's reload {reload_ms:.4f}) + {seg_us:.3f} us a "
        f"volume-step = {seg_ps:.2f} ps per voxel-step (choose_halo's T3D_STEP_S_PER_VOX "
        f"{halo.T3D_STEP_S_PER_VOX * 1e12:.2f}) on {name}")
    voxels = m * d * h * w
    bytes_moved = 28 * voxels * 4  # read 26 gates + x0, write 1
    ops = (54 * STEPS + 26) * voxels  # 27 FMA per voxel per step, the centre sum once
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, bytes_moved, ops)
    log(f"  cspn3d_fwd [{m},26,{d},{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms (keeping its "
        f"states {kept_ms:.4f}; {kernel_ms * 1e9 / (STEPS * voxels):.4f} ps per voxel-step), "
        f"{fwd_launches} CUDA launch per call (torch.profiler); fitted through 4 and {STEPS} steps "
        f"{fixed_ms:.4f} ms fixed + {step_us:.3f} us a volume-step, of which the grid barrier and "
        f"a step's latency {barrier_us:.3f} us (the same slope on {BARRIER_SHAPE}, one warp a "
        f"block); plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms, "
        f"operations {ops_ms:.4f} ms) on {name}")
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
        "kept_states_ms": kept_ms,  # the training forward, which keeps x_1..x_{T-1}
        "cuda_launches_per_call": fwd_launches,  # counted by torch.profiler in this run
        "fixed_ms": fixed_ms,
        "volume_step_us": step_us,
        "barrier_us": barrier_us,
        "segment_voxel_step_ps": seg_ps,
        "segment_fixed_ms": seg_fixed_ms,
        "ms_by_path": by_shape,
    }


def plain_vjp3d(gates, x0, ct, steps=STEPS):
    """The 3D backward kernel's plain version: autograd of the plain forward."""
    from cspn_tpu_torch.ops import cspn_ref

    gates, x0 = gates.detach().requires_grad_(True), x0.detach().requires_grad_(True)
    return torch.autograd.grad(cspn_ref.propagate_nd_reference(gates, x0, steps), (gates, x0), ct)


def check_cspn3d_bwd_kernel(name: str) -> dict:
    """Phase 3: the 3D CSPN backward kernel against autograd of the plain
    version, under a random cotangent, and its times at every path's
    shape."""
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    max_err = 0.0
    for label, (m, d, h, w), steps, zero_corner in cspn3d_cases():
        gates = gates3d(gen, m, d, h, w, zero_corner)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        ct = torch.randn(m, d, h, w, device="cuda", generator=gen)
        gk, xk = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        got = torch.autograd.grad(cspn3d_cuda.propagate3d(gk, xk, steps=steps), (gk, xk), ct)
        want = plain_vjp3d(gates, x0, ct, steps)
        torch.cuda.synchronize()
        for what, a, b in zip(("d gates", "d x0"), got, want):
            max_err = max(max_err, _check_close(
                f"cspn3d_bwd {label} [{m},26,{d},{h},{w}] steps={steps} {what}", a, b))
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

    by_shape = {}
    for label, (m, d, h, w), steps in cspn3d_path_shapes():
        gates = gates3d(gen, m, d, h, w)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        ct = torch.randn(m, d, h, w, device="cuda", generator=gen)
        states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)[1]
        ms = time_ms(lambda: cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps))
        counted, split = launches_per_call(
            lambda: cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps), CSPN3D_KERNELS,
            cspn3d_cuda.cuda_launches_per_call(steps)[1], f"cspn3d_bwd {label}")
        by_shape[label] = {"shape": [m, 26, d, h, w], "steps": steps, "ms": ms,
                           "cuda_launches_per_call": counted,
                           "split_ms": {k: v["ms"] for k, v in split.items()}}
        log(f"  cspn3d_bwd {label} [{m},26,{d},{h},{w}] steps={steps}: {ms:.4f} ms on the "
            f"forward's states; {counted} CUDA launches a call, by torch.profiler reverse sweep "
            f"{split['cspn3d_adj_sweep_kernel']['ms']:.4f} ms, gate cotangents "
            f"{split['cspn3d_gate_grad_kernel']['ms']:.4f} ms on {name}")
        if label == "stereo b4":
            # deterministic: gather form, no atomics
            again = cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps)
            first = cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError("cspn3d_bwd is not deterministic on the same states")
            main = (gates, x0, ct)
    gates, x0, ct = main
    kernel_ms = by_shape["stereo b4"]["ms"]
    plain_ms = time_ms(lambda: plain_vjp3d(gates, x0, ct), reps=5, warmup=1)
    m, d, h, w = STEREO_SHAPE
    voxels = m * d * h * w
    # read 26 gates + x0 + cotangent, write 26 + 1; per voxel 54 flops per
    # step of the forward, per reverse step and per step of gate
    # cotangents, and the centre and cbar sums (the function's own work:
    # the forward's kept states are a choice of this design)
    bytes_moved = 55 * voxels * 4
    ops = (54 * (STEPS - 1) + 54 * STEPS + 54 * STEPS + 52) * voxels
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, bytes_moved, ops)
    bwd_launches = by_shape["stereo b4"]["cuda_launches_per_call"]
    log(f"  cspn3d_bwd [{m},26,{d},{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms, "
        f"{bwd_launches} CUDA launches per call (torch.profiler), bit-identical when run twice; plain (forward + "
        f"autograd) {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms, "
        f"operations {ops_ms:.4f} ms) on {name}")
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
        "cuda_launches_per_call": bwd_launches,  # counted by torch.profiler in this run
        "ms_by_path": by_shape,
    }


def check_cspn3d_bf16_gates(name: str, fwd: dict, bwd: dict) -> None:
    """Phase 3: the 3D kernels on bf16 gates (gate_dtype bfloat16, the
    stereo and demo paths' route) against their plain version (the float32
    plain sweep on the gates rounded to bf16, its autograd for the
    backward) at every case of the float32 check, the kept states too, and
    timed beside the float32 route at every path's shape with their CUDA
    launches a call.  The rows `fwd` / `bwd` take the bf16 route's time and
    bound at the stereo b4 volume as "ms" / "bound_ms"; the float32 route's
    stay beside them (the sharded segment runs it)."""
    from cspn_tpu_torch.ops import cspn3d_cuda

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(6)
    err = {"fwd": 0.0, "bwd": 0.0}
    for label, (m, d, h, w), steps, zero_corner in cspn3d_cases():
        gates = gates3d(gen, m, d, h, w, zero_corner)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        ct = torch.randn(m, d, h, w, device="cuda", generator=gen)
        gk, xk = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        got = cspn3d_cuda.propagate3d(gk, xk, steps=steps, gate_dtype=bf16)
        got_g = torch.autograd.grad(got, (gk, xk), ct)
        gp, xp = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        want = cspn3d_cuda.propagate3d_reference(gp, xp, steps=steps, gate_dtype=bf16)
        want_g = torch.autograd.grad(want, (gp, xp), ct)
        torch.cuda.synchronize()
        what = f"[{m},26,{d},{h},{w}] steps={steps} bf16 gates"
        err["fwd"] = max(err["fwd"], _check_close(f"cspn3d_fwd {label} {what}", got.detach(),
                                                  want.detach()))
        for part, a, b in zip(("d gates", "d x0"), got_g, want_g):
            err["bwd"] = max(err["bwd"], _check_close(f"cspn3d_bwd {label} {what} {part}", a, b))
        out, states = cspn3d_cuda._launch(gates.to(bf16), x0, steps, keep_states=True)
        if not torch.equal(out, got.detach()):
            raise AssertionError(f"cspn3d_fwd {label} bf16 gates: keeping the states changed the "
                                 "output")
        rounded, want_states = cspn3d_cuda.round_gates(gates, bf16), [x0]
        for _ in range(steps - 1):
            want_states.append(cspn3d_cuda.propagate3d_reference(rounded, want_states[-1], steps=1))
        if steps > 1:
            err["fwd"] = max(err["fwd"], _check_close(
                f"cspn3d_fwd {label} bf16 gates, kept states x_1..x_{steps - 1}", states,
                torch.stack(want_states[1:])))
    by_shape = {"fwd": {}, "bwd": {}}
    for label, (m, d, h, w), steps in cspn3d_path_shapes():
        gates = gates3d(gen, m, d, h, w).to(bf16)
        x0 = torch.randn(m, d, h, w, device="cuda", generator=gen)
        ct = torch.randn(m, d, h, w, device="cuda", generator=gen)
        plan = cspn3d_cuda.device_plan(gates.device, d, h, w, 2)
        plan32 = cspn3d_cuda.device_plan(gates.device, d, h, w, 4)
        ms = time_ms(lambda: cspn3d_cuda._launch(gates, x0, steps))
        kept = time_ms(lambda: cspn3d_cuda._launch(gates, x0, steps, keep_states=True))
        states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)[1]
        bwd_ms = time_ms(lambda: cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps))
        n_fwd, _ = launches_per_call(lambda: cspn3d_cuda._launch(gates, x0, steps), CSPN3D_KERNELS,
                                     cspn3d_cuda.cuda_launches_per_call(steps)[0],
                                     f"cspn3d_fwd {label} bf16 gates")
        n_bwd, split = launches_per_call(
            lambda: cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps), CSPN3D_KERNELS,
            cspn3d_cuda.cuda_launches_per_call(steps)[1], f"cspn3d_bwd {label} bf16 gates")
        f32_fwd, f32_bwd = fwd["ms_by_path"][label]["ms"], bwd["ms_by_path"][label]["ms"]
        by_shape["fwd"][label] = {"ms": ms, "kept_states_ms": kept, "float32_ms": f32_fwd,
                                  "n_smem": plan.n_smem, "n_smem_float32": plan32.n_smem,
                                  "cuda_launches_per_call": n_fwd}
        by_shape["bwd"][label] = {"ms": bwd_ms, "float32_ms": f32_bwd,
                                  "cuda_launches_per_call": n_bwd,
                                  "split_ms": {k: v["ms"] for k, v in split.items()}}
        log(f"  cspn3d {label} [{m},26,{d},{h},{w}] steps={steps}, bf16 gates: forward {ms:.4f} ms "
            f"(float32 gates {f32_fwd:.4f}), keeping its states {kept:.4f} ms, backward "
            f"{bwd_ms:.4f} ms (float32 {f32_bwd:.4f}); gate planes in shared memory {plan.n_smem} "
            f"of 26 ({plan.smem_bytes} B a block; float32 {plan32.n_smem}, {plan32.smem_bytes} B); "
            f"{n_fwd} + {n_bwd} CUDA launches a call on {name}")
    m, d, h, w = STEREO_SHAPE
    voxels = m * d * h * w
    # forward: read 26 bf16 gates + x0, write 1 (60 B a voxel); backward:
    # read 26 bf16 gates, x0 and the cotangent, write 26 + 1 float32 planes
    bounds = {"fwd": bound(name, 60 * voxels, (54 * STEPS + 26) * voxels),
              "bwd": bound(name, 168 * voxels, (54 * (STEPS - 1) + 108 * STEPS + 52) * voxels)}
    for key, row in (("fwd", fwd), ("bwd", bwd)):
        row.update({
            "gate_dtype": "bfloat16 (stereo, demo3d); float32 (stereo_sharded's segment)",
            "ms_float32": row["ms"], "bound_ms_float32": row["bound_ms"],
            "bound_by_float32": row["bound_by"],
            "ms": by_shape[key]["stereo b4"]["ms"],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "max_abs_err": max(row["max_abs_err"], err[key]),
            "bf16_gates_by_path": by_shape[key],
        })
        if key == "fwd":
            row["kept_states_ms_float32"] = row["kept_states_ms"]
            row["kept_states_ms"] = by_shape[key]["stereo b4"]["kept_states_ms"]
        log(f"  cspn3d_{key} stereo b4 [{m},26,{d},{h},{w}] steps={STEPS}: bf16 gates "
            f"{row['ms']:.4f} ms against a bound of {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"float32 gates {row['ms_float32']:.4f} ms against {row['bound_ms_float32']:.4f} ms "
            f"on {name}")


def d2s_stage_inputs(gen, shape, crop, dtype, phase_form: bool):
    """A stage's input (its four phases [N, C, h, w] where `phase_form`, else
    one [N, 4C, h, w] tensor), its joined [N, 4C, h, w] tensor, a cotangent
    [N, C, oh, ow] and the uncropped [N, C, 2h, 2w] pixel_unshuffle takes."""
    n, c4, h, w = shape
    x = torch.randn(n, c4, h, w, device="cuda", generator=gen).to(dtype)
    ct = torch.randn(n, c4 // 4, *crop, device="cuda", generator=gen).to(dtype)
    full = torch.randn(n, c4 // 4, 2 * h, 2 * w, device="cuda", generator=gen).to(dtype)
    form = [p.contiguous() for p in x.chunk(4, 1)] if phase_form else x
    return form, x, ct, full


def phase_form(shape) -> bool:
    """Whether the decoder hands this stage's depth-to-space the four phase
    convs' outputs: from 128 features (models/decoder.py:_subpixel_convs),
    layers 1-3 of the b8 nyu_eval decoder."""
    return shape[1] // 4 >= 128


def d2s_routes(d2s, form, x, ct, oh, ow, takes_phases: bool) -> dict:
    """The calls a depth-to-space stage is timed by, for any checkout's
    ops/d2s.py: "d2s joined" / "s2d joined" the kernels on one [N, 4C, h,
    w] tensor; "d2s path" from the stage's form to the output (where the
    decoder gives four phases: the kernel on them where the tree takes them,
    else torch.cat and the kernel on the concatenation); "s2d path" from
    the cotangent to the stage's gradients (four contiguous phase
    gradients: one s2d where the tree writes them, else s2d and the slice
    copies a conv's backward takes)."""
    h, w = x.shape[2:]
    calls = {"d2s joined": lambda: d2s._launch(x, oh, ow),
             "s2d joined": lambda: d2s._launch_bwd(ct, h, w)}
    if isinstance(form, torch.Tensor):
        calls["d2s path"], calls["s2d path"] = calls["d2s joined"], calls["s2d joined"]
    elif takes_phases:
        calls["d2s path"] = lambda: d2s._launch(form, oh, ow)
        calls["s2d path"] = lambda: d2s._launch_bwd(ct, h, w, phases=True)
    else:
        calls["d2s path"] = lambda: d2s._launch(torch.cat(form, 1), oh, ow)
        calls["s2d path"] = lambda: [g.contiguous() for g in d2s._launch_bwd(ct, h, w).chunk(4, 1)]
    return calls


def check_d2s_kernels(name: str) -> list[dict]:
    """Phase 3: the depth-to-space kernel and its adjoint, in both forms
    (one [N, 4C, h, w] tensor, and the four phases [N, C, h, w] the decoder
    hands over from 128 features), against the plain version and its
    autograd, bit for bit, under a random cotangent, at the b8 decoder's
    five stages in float32 and bf16 and at odd shapes (C = 1, unaligned
    rows of 19 and 38 values, N = 1 and 3, float64).  Then each stage timed
    queued (`time_queued_ms`: a call takes microseconds on the card, less
    than its launch on the host) in its path's form: the kernels (`d2s`
    from the stage's input to the output, `s2d` from the cotangent to its
    gradients: four contiguous phase gradients at layers 1-3), beside the
    kernels on the joined tensor alone, torch.cat + the kernel (and s2d +
    the four slice copies), the plain version, torch.cat + F.pixel_shuffle
    (F.pixel_unshuffle + the slice copies: the same bytes moved in
    PyTorch's own channel order, without the crop) and the byte bound.
    Each row sums a b8 forward's nine calls (`d2s`) or a backward's nine
    (`s2d`)."""
    import torch.nn.functional as F

    from cspn_tpu_torch.ops import d2s

    gen = torch.Generator(device="cuda").manual_seed(5)
    layer3 = D2S_STAGES[2]
    cases = [(f"{stage} {str(dt).removeprefix('torch.')}", shape, crop, dt, form)
             for stage, shape, crop, _ in D2S_STAGES for dt in (torch.float32, torch.bfloat16)
             for form in {False, phase_form(shape)}]
    cases += [("odd C=1 float32", (3, 4, 5, 7), (9, 13), torch.float32, form) for form in (0, 1)]
    cases += [("layer3 float64", layer3[1], layer3[2], torch.float64, form) for form in (0, 1)]
    cases += [(f"w={w} N={n} C=1 {str(dt).removeprefix('torch.')}", (n, 4, h, w), (2 * h - 1, 2 * w),
               dt, True) for n, h, w in ((1, 10, 19), (3, 15, 38)) for dt in (torch.bfloat16,
                                                                               torch.float32)]
    max_err = {"d2s": 0.0, "s2d": 0.0}
    for label, shape, (oh, ow), dtype, phases in cases:
        form, _, ct, _ = d2s_stage_inputs(gen, shape, (oh, ow), dtype, phases)
        xs = form if phases else [form]
        outs = {}
        for kind, fn in (("kernel", d2s.depth_to_space2), ("plain", d2s.depth_to_space2_ref)):
            xg = [t.clone().requires_grad_(True) for t in xs]
            y = fn(xg if phases else xg[0], oh, ow)
            outs[kind] = (y, torch.cat(torch.autograd.grad(y, xg, ct), 1))
        torch.cuda.synchronize()
        for what, a, b in zip(("d2s", "s2d"), outs["kernel"], outs["plain"]):
            err = (a.double() - b.double()).abs().max().item()
            log(f"  {what} {label} {'four phases' if phases else 'one tensor'} {list(shape)} -> "
                f"crop ({oh},{ow}): max|err| = {err:.3e} (bit-exact required)")
            if not (a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)):
                raise AssertionError(f"{what} {label}: kernel differs from the plain version "
                                     f"(max|err| {err:.3e})")
            max_err[what] = max(max_err[what], err)

    # per b8 pass, for each dtype: the path's kernel, the kernel on the
    # joined tensor, torch.cat + kernel, plain, library, bound
    keys = ("ms", "joined_ms", "cat_kernel_ms", "plain_ms", "library_ms", "bound_ms")
    sums = {dt: {k: dict.fromkeys(keys, 0.0) for k in max_err}
            for dt in (torch.float32, torch.bfloat16)}
    for (stage, shape, (oh, ow), calls), dtype in itertools.product(
            D2S_STAGES, (torch.float32, torch.bfloat16)):
        n, c4, h, w = shape
        form, x, ct, full = d2s_stage_inputs(gen, shape, (oh, ow), dtype, phase_form(shape))
        split = not isinstance(form, torch.Tensor)
        mine = d2s_routes(d2s, form, x, ct, oh, ow, True)
        old = d2s_routes(d2s, form, x, ct, oh, ow, False)

        def join(t):
            return torch.cat(t, 1) if split else t

        def phases_of(g):
            return [p.contiguous() for p in g.chunk(4, 1)] if split else g

        kept = n * (c4 // 4) * oh * ow * x.element_size()  # bytes of the values the crop keeps
        timed = {
            "d2s": (mine["d2s path"], mine["d2s joined"], old["d2s path"],
                    lambda: d2s.depth_to_space2_ref(form, oh, ow),
                    lambda: F.pixel_shuffle(join(form), 2), 2 * kept),
            "s2d": (mine["s2d path"], mine["s2d joined"], old["s2d path"],
                    lambda: phases_of(d2s.space_to_depth2_ref(ct, h, w)),
                    lambda: phases_of(F.pixel_unshuffle(full, 2)),
                    kept + x.numel() * x.element_size()),
        }
        for what, (*fns, bytes_moved) in timed.items():
            got = dict(zip(keys, [time_queued_ms(f) for f in fns] + [bound(name, bytes_moved, 0)[0]]))
            log(f"  {what} {stage} {'four phases' if split else 'one tensor'} [{n},{c4},{h},{w}] "
                f"<-> [{n},{c4 // 4},{oh},{ow}] {'bf16' if dtype == torch.bfloat16 else 'f32'}: "
                f"kernel {got['ms']:.4f} ms (on the joined tensor {got['joined_ms']:.4f}, "
                f"{'torch.cat + kernel' if what == 'd2s' else 'kernel + slice copies'} "
                f"{got['cat_kernel_ms']:.4f}), plain {got['plain_ms']:.4f} ms, "
                f"{'torch.cat + ' if split and what == 'd2s' else ''}"
                f"F.pixel_{'un' if what == 's2d' else ''}shuffle"
                f"{' + slice copies' if split and what == 's2d' else ''} {got['library_ms']:.4f} "
                f"ms, bound {got['bound_ms']:.4f} ms ({bytes_moved / 1e6:.1f} MB) on {name}; "
                f"{calls} per {'forward' if what == 'd2s' else 'backward'}")
            for key, v in got.items():
                sums[dtype][what][key] += calls * v
    rows = []
    for what, tpu_line in (("d2s", 118), ("s2d", 137)):
        for dtype, sm in sums.items():
            sm = sm[what]
            log(f"  {what} per b8 {'forward' if what == 'd2s' else 'backward'} (9 calls), "
                f"{str(dtype).removeprefix('torch.')}: kernel {sm['ms']:.4f} ms "
                f"({100 * sm['bound_ms'] / sm['ms']:.0f}% of its bound; on the joined tensors "
                f"{sm['joined_ms']:.4f}, with torch.cat / slice copies {sm['cat_kernel_ms']:.4f}), "
                f"plain {sm['plain_ms']:.4f} ms, library {sm['library_ms']:.4f} ms, bound "
                f"{sm['bound_ms']:.4f} ms on {name}")
        f32, bf16 = sums[torch.float32][what], sums[torch.bfloat16][what]
        rows.append({
            "name": what,
            "route": "cuda",
            "source": "cspn_tpu_torch/csrc/d2s.cu",
            "replaces": f"cspn_tpu/ops/d2s_pallas.py:{tpu_line}",
            "launches": None,
            "max_abs_err": max_err[what],
            **{k: f32[k] for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes",  # the kernels compute nothing
            # torch.cat + F.pixel_shuffle (F.pixel_unshuffle + the slice
            # copies): the same bytes in PyTorch's channel order, no crop
            "library_ms": f32["library_ms"],
            # the bf16 decoder's (phase 13: bf16 serving and training)
            "dtype": "float32 (nyu_train, the float32 paths); bfloat16 (phase 13)",
            **{f"{k}_bfloat16": bf16[k] for k in keys},
            **{k: f32[k] for k in ("joined_ms", "cat_kernel_ms")},
        })
    rows[0]["stage_profile"] = profile_phase_stage(name)
    return rows


def profile_phase_stage(name: str, reps: int = 3) -> dict:
    """Phase 3: layer2 of the b8 decoder at bf16 (the four phase convs of a
    5x5 subpixel conv, 512 features from 256, into depth-to-space, forward
    and backward under a random cotangent) in both forms: the four phases
    handed to depth_to_space2, and torch.cat + depth_to_space2 of the joined
    tensor (the form before the kernels took the phases).  For each, every
    kernel the card ran by name (launches and device ms a step, by
    torch.profiler: what the joined form's backward adds where the convs'
    backward reads strided slices of s2d's output), and the whole step
    queued (time_queued_ms), the two forms in turns."""
    from torch.profiler import ProfilerActivity, profile

    from cspn_tpu_torch.models import decoder
    from cspn_tpu_torch.ops import d2s

    gen = torch.Generator(device="cuda").manual_seed(11)
    _, (n, c4, h, w), (oh, ow), _ = D2S_STAGES[1]
    x = torch.randn(n, 256, h, w, device="cuda", generator=gen).to(torch.bfloat16)
    weight = (0.02 * torch.randn(c4 // 4, 256, 5, 5, device="cuda", generator=gen)).to(
        torch.bfloat16).requires_grad_(True)
    ct = torch.randn(n, c4 // 4, oh, ow, device="cuda", generator=gen).to(torch.bfloat16)
    x.requires_grad_(True)

    def step(joined: bool):
        ys = [decoder._conv(x, k, ph, pw) for k, ph, pw in decoder._subpixel_convs(weight)]
        y = d2s.depth_to_space2(torch.cat(ys, 1) if joined else ys, oh, ow)
        torch.autograd.backward(y, ct)

    out = {"shape": [n, c4, h, w], "crop": [oh, ow], "cin": 256}
    for label, joined in (("four phases", False), ("torch.cat + joined", True)):
        for _ in range(3):
            step(joined)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step(joined)
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            kernels[e.key[:120]] = {"launches": e.count / reps, "ms": us / 1e3 / reps}
        out[label] = {"kernels": kernels, "device_ms": sum(k["ms"] for k in kernels.values())}
        log(f"  layer2 bf16 phase convs + depth-to-space, forward and backward, {label}: "
            f"{out[label]['device_ms']:.4f} device ms a step (torch.profiler) on {name}")
        for key, k in sorted(kernels.items(), key=lambda kv: -kv[1]["ms"]):
            log(f"    {k['launches']:.0f} x {k['ms']:.4f} ms  {key}")
    ms = {label: [] for label in ("four phases", "torch.cat + joined")}
    for label in ("four phases", "torch.cat + joined", "torch.cat + joined", "four phases"):
        ms[label].append(time_queued_ms(functools.partial(step, label != "four phases"), calls=4))
    out["step_ms"] = ms
    log("  layer2 step queued (4 a window: ~80 launches a step), in turns: " + "; ".join(
        f"{label} " + " / ".join(f"{v:.4f}" for v in vals) + " ms" for label, vals in ms.items()))
    return out


def check_tiled_kernel(name: str) -> dict:
    """Phase 3: the tiled 2D CSPN forward against its plain version and
    cspn2d_fwd's values at every CSPN2D_CASES and TILED_SERVED_CASES case;
    cspn2d_cuda's routing at kitti_benchmark's training batch (no backward:
    tiled; with one: cspn2d_fwd keeping its states, then cspn2d_bwd, against
    autograd of the plain version under a random cotangent); then timed
    beside cspn2d_fwd at the KITTI batch, its CUDA launches a call counted
    by torch.profiler, and cspn2d_bwd timed there on both routes (the KITTI
    train step's backward runs on the kept states)."""
    from cspn_tpu_torch.ops import cspn_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    n, h, w = KITTI_SHAPE
    max_err = 0.0
    cases = CSPN2D_CASES + TILED_SERVED_CASES
    for label, (cn, ch, cw), with_sparse, norm in cases:
        g, b, s = cspn_inputs(gen, cn, ch, cw, with_sparse, negative=0.2)
        g[0, :, :6, :6] = 0.0  # zero gates: the 0/0 guard
        got = cspn_cuda._launch_tiled(g, b, s, STEPS, norm)
        kept = cspn_cuda._launch(g, b, s, STEPS, norm)[0]
        want = cspn_ref.cspn2d_reference(g.movedim(1, -1), b, s, steps=STEPS, norm_type=norm)
        torch.cuda.synchronize()
        max_err = max(max_err, _check_close(f"cspn2d_tiled {label} [{cn},8,{ch},{cw}] steps={STEPS}",
                                            got, want))
        if not torch.equal(got, kept):
            raise AssertionError(f"cspn2d_tiled {label}: values differ from cspn2d_fwd's "
                                 f"(max {(got - kept).abs().max().item():.3e})")
    log(f"  cspn2d_tiled equals cspn2d_fwd value for value in all {len(cases)} cases")

    # through the wrapper: a forward without a backward runs the tiled
    # kernel, one with a backward cspn2d_fwd and cspn2d_bwd
    g, b, s = cspn_inputs(gen, n, h, w, True, negative=0.2)
    ct = torch.randn(n, h, w, device="cuda", generator=gen)
    before = (cspn_cuda.tiled_launches, cspn_cuda.launches, cspn_cuda.bwd_launches)
    with torch.no_grad():
        inference = cspn_cuda.cspn2d_cuda(g, b, s, steps=STEPS, channel_first=True)
    gk, bk = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
    out = cspn_cuda.cspn2d_cuda(gk, bk, s, steps=STEPS, channel_first=True)
    got = torch.autograd.grad(out, (gk, bk), ct)
    ran = tuple(a - z for a, z in zip((cspn_cuda.tiled_launches, cspn_cuda.launches,
                                       cspn_cuda.bwd_launches), before))
    if ran != (1, 1, 1) or not torch.equal(inference, out):
        raise AssertionError(f"KITTI b4 through cspn2d_cuda launched (tiled, fwd, bwd) {ran}, "
                             "expected (1, 1, 1) with equal forwards")
    for what, a, x in zip(("dguidance", "dblur"), got, plain_vjp(g, b, s, ct)):
        max_err = max(max_err, _check_close(
            f"cspn2d_fwd (states kept) + cspn2d_bwd kitti b4 [{n},8,{h},{w}] steps={STEPS} {what}",
            a, x))
    del got, out, gk, bk, inference

    g, b, s = cspn_inputs(gen, n, h, w, True)
    kernel_ms = time_ms(lambda: cspn_cuda._launch_tiled(g, b, s, STEPS, "8sum"))
    fwd_kept_ms = time_ms(lambda: cspn_cuda._launch(g, b, s, STEPS, "8sum"))
    counted, found = launches_per_call(lambda: cspn_cuda._launch_tiled(g, b, s, STEPS, "8sum"),
                                       CSPN2D_KERNELS,
                                       cspn_cuda.cuda_launches_per_call(STEPS)["cspn2d_tiled"],
                                       "cspn2d_tiled at KITTI b4")
    # the backward at this shape on both routes (the repair of its KITTI
    # figure: the path runs it on the kept states)
    kept = cspn_cuda._launch(g, b, s, STEPS, "8sum")[1:]
    bwd_kept_ms = time_ms(lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum", kept))
    bwd_replay_ms = time_ms(lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum"))
    bwd_counted = launches_per_call(
        lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum", kept), CSPN2D_KERNELS,
        cspn_cuda.cuda_launches_per_call(STEPS)["cspn2d_bwd_kept"], "cspn2d_bwd kept at KITTI b4")[0]
    bwd_bound_ms, _, bwd_kept_bound_ms = bwd_floors(name, n, h, w)
    del kept
    g_last = g.movedim(1, -1)
    plain_ms = time_ms(lambda: cspn_ref.cspn2d_reference(g_last, b, s, steps=STEPS), reps=5, warmup=1)
    bytes_moved = 11 * n * h * w * 4  # read 8 guidance + blur + sparse, write 1
    ops = 17 * STEPS * n * h * w
    bound_ms, bound_by, bytes_ms, ops_ms = bound(name, bytes_moved, ops)
    log(f"  cspn2d_tiled [{n},8,{h},{w}] steps={STEPS}: kernel {kernel_ms:.4f} ms ({counted} CUDA "
        f"launches a call, by torch.profiler {found}), cspn2d_fwd keeping its states "
        f"{fwd_kept_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
        f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms) on {name}")
    log(f"  cspn2d_bwd at [{n},8,{h},{w}] steps={STEPS}: on the forward's kept states "
        f"{bwd_kept_ms:.4f} ms ({bwd_counted} CUDA launches a call), replaying them "
        f"{bwd_replay_ms:.4f} ms; bound {bwd_bound_ms:.4f} ms (20 planes, the replay route's "
        f"floor), the kept route's floor {bwd_kept_bound_ms:.4f} ms on {name}")
    return {
        "name": "cspn2d_tiled",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/cspn2d_tiled.cu",
        "replaces": "cspn_tpu/ops/cspn_pallas.py:799",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes CSPN
        "cuda_launches_per_call": counted,  # counted by torch.profiler in this run
        "cspn2d_fwd_ms": fwd_kept_ms,  # cspn2d_fwd.cu on the same inputs, keeping its states
        # cspn2d_bwd.cu at this shape: the KITTI train step's backward
        "cspn2d_bwd_kept_ms": bwd_kept_ms,
        "cspn2d_bwd_replay_ms": bwd_replay_ms,
        "cspn2d_bwd_bound_ms": bwd_bound_ms,
        "cspn2d_bwd_kept_bound_ms": bwd_kept_bound_ms,
        "cspn2d_bwd_cuda_launches_per_call": bwd_counted,
    }


def time_fwd_routes(name: str, shapes=FWD_ROUTE_SHAPES, count_launches: bool = True) -> list[dict]:
    """At each shape (24 steps, 8sum, 500 samples), each 2D CSPN kernel
    call and route by CUDA events around one call (`<what>_ms`) and as the
    device time of a call among queued ones (`<what>_queued_ms`): both
    forwards (`tiled`; `fwd_kept`, the forward that keeps its states, the
    train paths' forward), the backward on those kept states (`bwd_kept`,
    the paths' route) and replaying them (`bwd_replay`), and the two ways
    to run a train step's forward and backward, the tiled forward then the
    replaying backward (`train_tiled`) or the forward keeping its states
    then the backward on them (`train_kept`: ops/cspn_cuda.py:use_tiled is
    set from these); with `count_launches`, each call's CUDA launches,
    counted by torch.profiler and held to
    ops/cspn_cuda.py:cuda_launches_per_call.  It drives only the wrappers'
    `_launch`, `_launch_tiled` and `_launch_bwd`, which every tree since
    the backward took kept states has, so that it times any checkout's
    kernels (--routes-of); where a tree's `_launch` takes `keep_states`,
    it is asked for the states."""
    from cspn_tpu_torch.ops import cspn_cuda

    fwd_kept = cspn_cuda._launch
    if "keep_states" in inspect.signature(fwd_kept).parameters:
        fwd_kept = functools.partial(fwd_kept, keep_states=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for n, h, w in shapes:
        g, b, s = cspn_inputs(gen, n, h, w, True)
        ct = torch.randn(n, h, w, device="cuda", generator=gen)
        kept = fwd_kept(g, b, s, STEPS, "8sum")[1:]

        def train_tiled():
            cspn_cuda._launch_tiled(g, b, s, STEPS, "8sum")
            cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum")

        def train_kept():
            states = fwd_kept(g, b, s, STEPS, "8sum")[1:]
            cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum", states)

        calls = {
            "tiled": lambda: cspn_cuda._launch_tiled(g, b, s, STEPS, "8sum"),
            "fwd_kept": lambda: fwd_kept(g, b, s, STEPS, "8sum"),
            "bwd_kept": lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum", kept),
            "bwd_replay": lambda: cspn_cuda._launch_bwd(g, b, s, ct, STEPS, "8sum"),
            "train_tiled": train_tiled,
            "train_kept": train_kept,
        }
        row = {"shape": [n, h, w]}
        for what, fn in calls.items():
            row[f"{what}_ms"], row[f"{what}_queued_ms"] = time_ms(fn), time_queued_ms(fn)
        if count_launches:
            want = cspn_cuda.cuda_launches_per_call(STEPS)
            row["cuda_launches_per_call"] = {
                key: launches_per_call(calls[what], CSPN2D_KERNELS, want[key],
                                       f"{key} at {[n, h, w]}")[0]
                for key, what in (("cspn2d_tiled", "tiled"), ("cspn2d_fwd", "fwd_kept"),
                                  ("cspn2d_bwd_kept", "bwd_kept"),
                                  ("cspn2d_bwd_replay", "bwd_replay"))}
        del kept, calls
        log(f"  2D CSPN at [{n},8,{h},{w}] steps={STEPS}, ms by events (queued): "
            + ", ".join(f"{what} {row[f'{what}_ms']:.4f} ({row[f'{what}_queued_ms']:.4f})"
                        for what in ("tiled", "fwd_kept", "bwd_kept", "bwd_replay", "train_tiled",
                                     "train_kept"))
            + (f"; CUDA launches a call {row['cuda_launches_per_call']}" if count_launches else "")
            + f" on {name}")
        rows.append(row)
    return rows


def time_halo_seg_routes(name: str) -> list[dict]:
    """The sharded segment's kernels at kitti_sharded's b4 train segment
    (S = 2, with keep, the inputs parallel/halo.py:first_segment_inputs
    builds) at the cost model's K and at K = HALO_K, by CUDA events around
    one call (`<what>_ms`) and as the device time of a call among queued
    ones (`<what>_queued_ms`): the forward that no backward follows
    (`fwd`), the backward (`bwd`) and a train step's forward and backward
    (`train`: the forward as `_HaloSegment` runs it when a backward
    follows, then the backward).  On a tree whose `_launch` takes
    `keep_states` the train forward keeps its states (`fwd_kept`) and the
    backward reads them; on an older one the train forward is `fwd` and
    the backward replays.  It drives only ops/cspn_halo_cuda.py's `_launch`
    and `_launch_bwd`, so that it times any checkout's kernels
    (--routes-of)."""
    from cspn_tpu_torch.ops import cspn_halo_cuda
    from cspn_tpu_torch.parallel import halo, make_mesh

    kept_route = "keep_states" in inspect.signature(cspn_halo_cuda._launch).parameters
    gen = torch.Generator(device="cuda").manual_seed(13)
    n, h, w = KITTI_SHAPE
    g, b, sp = cspn_inputs(gen, n, h, w, True, negative=0.2)
    rows, kept = [], None
    for halo_k in (None, HALO_K):
        with torch.no_grad():
            *inputs, k = halo.first_segment_inputs(g, b, sp, mesh=make_mesh(spatial=2),
                                                   steps=STEPS, halo=halo_k, channel_first=True)
        gates, base, keep, x = inputs
        ct = torch.randn(x.shape, device="cuda", generator=gen)
        calls = {"fwd": lambda: cspn_halo_cuda._launch(*inputs, k)}
        if kept_route:
            calls["fwd_kept"] = lambda: cspn_halo_cuda._launch(*inputs, k, keep_states=True)
            kept = calls["fwd_kept"]()[1:]
            calls["bwd"] = lambda: cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k, kept)

            def train():
                cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k, calls["fwd_kept"]()[1:])
        else:
            def train():
                cspn_halo_cuda._launch(*inputs, k)
                cspn_halo_cuda._launch_bwd(*inputs, ct, k)

            calls["bwd"] = lambda: cspn_halo_cuda._launch_bwd(*inputs, ct, k)
        calls["train"] = train
        row = {"shape": list(gates.shape), "k": k, "kept_route": kept_route}
        for what, fn in calls.items():
            row[f"{what}_ms"], row[f"{what}_queued_ms"] = time_ms(fn), time_queued_ms(fn)
        log(f"  segment {row['shape']} K={k} with keep, ms by events (queued): "
            + ", ".join(f"{what} {row[f'{what}_ms']:.4f} ({row[f'{what}_queued_ms']:.4f})"
                        for what in calls) + f" on {name}")
        rows.append(row)
        del inputs, gates, base, keep, x, calls
        kept = None
    return rows


def time_paddle(name: str) -> list[dict]:
    """Row 6 at each of PADDLE_CASES (channel-last, 24 steps), by CUDA
    events around one call (`<what>_ms`) and queued (`<what>_queued_ms`):
    the kernel alone (`kernel`) and cspn_nd's whole 2D forward without autograd
    (`cspn_nd`: on a tree with `paddle2d_layout`, that layout's PyTorch
    launches, the kernel and the output's relayout).  It drives only
    `_launch` and `cspn_nd`, so that it times any checkout's kernel
    (--routes-of)."""
    from cspn_tpu_torch.ops import cspn_paddle2d_cuda as p2
    from cspn_tpu_torch.ops.cspn import cspn_nd

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for n, h, w, c in PADDLE_CASES:
        guide, feat = paddle_inputs(gen, n, h, w, c)
        if hasattr(p2, "paddle2d_layout"):  # a tree whose kernel takes the normalized gates
            gates, x0 = p2.paddle2d_layout(guide, feat)
            calls = {"kernel": lambda: p2._launch(gates, x0, STEPS)}
        else:
            calls = {"kernel": lambda: p2._launch(guide, feat, STEPS)}

        def forward():
            with torch.no_grad():
                return cspn_nd(guide, feat, steps=STEPS)

        calls["cspn_nd"] = forward
        row = {"shape": [n, h, w, c]}
        for what, fn in calls.items():
            row[f"{what}_ms"], row[f"{what}_queued_ms"] = time_ms(fn), time_queued_ms(fn)
        log(f"  paddle2d [{n * c},8,{h},{w}], ms by events (queued): "
            + ", ".join(f"{what} {row[f'{what}_ms']:.4f} ({row[f'{what}_queued_ms']:.4f})"
                        for what in calls) + f" on {name}")
        rows.append(row)
    return rows


def time_demo2d_split(name: str, iters: int = 21, warmup: int = 3) -> dict:
    """`demo --dim-num 2`'s iteration (batch 3, [64,128] maps, C = 1, 24
    steps, Adam) split by CUDA events into the forward (cspn_nd and the
    mean), the backward (autograd of the plain version on the card) and
    Adam's step; medians of `iters` iterations.  Any checkout (--routes-of)."""
    from cspn_tpu_torch.ops.cspn import cspn_nd

    rng = np.random.default_rng(0)  # the demo's draws
    params = [torch.tensor(rng.random(shape), dtype=torch.float32, device="cuda",
                           requires_grad=True) for shape in ((3, 64, 128, 8), (3, 64, 128, 1))]
    opt = torch.optim.Adam(params, lr=1e-3)
    split = {"forward": [], "backward": [], "adam": []}
    for i in range(warmup + iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = cspn_nd(*params, steps=STEPS).mean()
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        ev[3].synchronize()
        if i >= warmup:
            for k, (a, b) in zip(split, zip(ev, ev[1:])):
                split[k].append(a.elapsed_time(b))
    row = {f"{k}_ms": statistics.median(v) for k, v in split.items()}
    row["iteration_ms"] = sum(row.values())
    log("  demo --dim-num 2 iteration, ms by events (median of "
        f"{iters}): " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + f" on {name}")
    return row


def time_probe_and_paddle(name: str) -> dict:
    """Rows 11 and 6 by CUDA events around one call and queued (as
    check_step_probe and check_paddle2d_kernel time them: the probe's
    PROBE_ROW_ITERS-iteration f32 launch on one block per SM; paddle2d by
    time_paddle), the demo's iteration split (time_demo2d_split), and the
    probe path's slopes (step_probe.run_probe, as probe_slice runs it).
    It drives only the wrappers' `_launch`, `cspn_nd` and `run_probe`, so
    that it times any checkout's kernels (--routes-of)."""
    from cspn_tpu_torch.utils import step_probe

    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    g, x = step_probe.probe_inputs(blocks, torch.float32, torch.float32, device="cuda")
    probe = lambda: step_probe._launch(g, x, PROBE_ROW_ITERS)  # noqa: E731
    row = {"step_probe_ms": time_ms(probe), "step_probe_queued_ms": time_queued_ms(probe),
           "paddle2d": time_paddle(name), "demo2d_split": time_demo2d_split(name),
           "probe_slopes": step_probe.run_probe(trials=PROBE_TRIALS)}
    log(f"  step_probe f32/f32 iters={PROBE_ROW_ITERS}: {row['step_probe_ms']:.4f} ms by events, "
        f"{row['step_probe_queued_ms']:.4f} queued on {name}")
    for r in row["probe_slopes"]:
        log(f"  probe slope {r['gate_dtype']}/{r['state_dtype']}: {r['ns_per_iter']:.3f} ns per "
            f"iteration, {r['ps_per_px_iter']:.5f} ps per px-iteration, {r['Tops_per_s']:.3f} "
            f"Tops/s on {name}")
    return row


def ptxas_usage(build, names) -> dict:
    """Each kernel's registers and spill bytes as `ptxas -v` reports them,
    compiling the libraries `names` of the `_build` module `build` (a
    checkout's own sources and flags) once more with -Xptxas -v."""
    usage = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {lib: subprocess.Popen([*build.nvcc_command(lib, os.path.join(tmp, f"{lib}.so")),
                                        "-Xptxas", "-v"], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True) for lib in names}
        for lib, proc in procs.items():
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v {lib} failed:\n{out}")
            kernel = None
            for line in out.splitlines():
                if m := re.search(r"Compiling entry function '([^']+)'", line):
                    kernel = m.group(1)
                elif kernel and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                                line)):
                    usage.setdefault(kernel, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
                elif kernel and (m := re.search(r"Used (\d+) registers", line)):
                    usage.setdefault(kernel, {})["registers"] = int(m.group(1))
    for kernel, u in usage.items():
        log(f"  ptxas: {kernel}: {u.get('registers')} registers, {u.get('spill_bytes')} bytes "
            "of spill stores and loads")
    return usage


def time_d2s_routes(name: str) -> dict:
    """The depth-to-space stages of a b8 pass (D2S_STAGES) at float32 and
    bf16, queued, through d2s_routes for the checkout whose cspn_tpu_torch
    is imported: the kernels on the joined tensors, and the forward and
    backward in the decoder's form (where a tree's `_launch_bwd` takes no
    `phases`, torch.cat before its kernel and slice copies after).  Sums a
    b8 pass's nine calls of each (--routes-of)."""
    from cspn_tpu_torch.ops import d2s

    takes_phases = "phases" in inspect.signature(d2s._launch_bwd).parameters
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"takes_phases": takes_phases}
    for dtype in (torch.float32, torch.bfloat16):
        sums = {}
        for stage, shape, crop, calls in D2S_STAGES:
            form, x, ct, _ = d2s_stage_inputs(gen, shape, crop, dtype, phase_form(shape))
            for key, fn in d2s_routes(d2s, form, x, ct, *crop, takes_phases).items():
                ms = time_queued_ms(fn)
                sums[key] = sums.get(key, 0.0) + calls * ms
                log(f"  {key} {stage} {str(dtype).removeprefix('torch.')}: {ms:.4f} ms on {name}")
        out[str(dtype).removeprefix("torch.")] = sums
        log(f"  per b8 pass, {dtype}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items()))
    return out


# the libraries of the kernels on the column march (rows 1-6)
MARCH_LIBS = ("cspn2d_fwd", "cspn2d_bwd", "cspn2d_tiled", "cspn2d_halo_seg",
              "cspn2d_halo_seg_bwd", "paddle2d")


def routes_of(checkout: str, d2s_only: bool = False) -> int:
    """`chip_smoke.py --routes-of CHECKOUT`: time_fwd_routes (without
    counting launches), time_halo_seg_routes, time_probe_and_paddle and
    time_d2s_routes on the cspn_tpu_torch of CHECKOUT (another tree's
    kernels built from its own sources, or this one's with "."), and
    ptxas_usage of its probe, its march kernels (rows 1-6, MARCH_LIBS) and
    its depth-to-space kernels; with `d2s_only` (--d2s-only) the
    depth-to-space stages and their ptxas alone.  Prints the card line and
    one JSON object, and runs nothing else.  One harness times a parent and
    a change in turns."""
    root = os.path.abspath(checkout)
    sys.path.insert(0, root)
    import cspn_tpu_torch

    if not os.path.abspath(cspn_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"cspn_tpu_torch came from {cspn_tpu_torch.__file__}, not {root}")
    from cspn_tpu_torch.ops import _build

    name, card = torch.cuda.get_device_name(0), card_line()
    result = {"card": card, "package": cspn_tpu_torch.__file__, "steps": STEPS}
    if not d2s_only:
        result["fwd_routes"] = time_fwd_routes(name, count_launches=False)
        result["halo_seg_routes"] = time_halo_seg_routes(name)
        result["probe_and_paddle"] = time_probe_and_paddle(name)
    result["d2s_routes"] = time_d2s_routes(name)
    result["ptxas"] = ptxas_usage(_build, ("d2s",) if d2s_only else ("step_probe", *MARCH_LIBS,
                                                                     "d2s"))
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def train_step_ms(model, optimizer, loss_fn, x, target) -> float:
    """Median device ms of one train step (forward, loss, backward,
    optimizer step; time_ms: CUDA events around each step)."""
    model.train()

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss_fn(model(x), target).backward()
        optimizer.step()

    return time_ms(step, reps=11, warmup=2)


def ddp_steps_ms(name: str, peaks: dict) -> dict:
    """The nyu_train b8 train step (make_train_step) through
    DistributedDataParallel on a 1-rank NCCL group made here, on the
    sync-BN route and the bf16 route (train_step_ms's timing: median of 11
    whole steps); each route's peak memory into `peaks`."""
    import torch.distributed as dist

    from cspn_tpu_torch.config import PRESETS
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.parallel import make_mesh
    from cspn_tpu_torch.parallel.data import DataParallel
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.utils.profiling import NYU_HW

    cfg = PRESETS["nyu_train"]
    ds = SyntheticDepthDataset(length=8, hw=NYU_HW, n_sample=cfg.data.n_sample, seed=1)
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(8)])).cuda()
    depth = torch.from_numpy(np.stack([ds[i]["depth"] for i in range(8)])).cuda()
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(None, 1, dist.group.WORLD)
        for route in ("sync", "bf16"):
            model = build_model(cfg, train=True, device="cuda", seed=0)
            dp = DataParallel(model, mesh, None if route == "sync" else "bfloat16")
            step = make_train_step(model, make_optimizer(model.parameters()), data_parallel=dp)
            torch.cuda.reset_peak_memory_stats()
            label = f"nyu_train b8 ddp {route}"
            out[label] = time_ms(functools.partial(step, x, depth), reps=11, warmup=2)
            peaks[label] = torch.cuda.max_memory_allocated() / 2**30
            log(f"  {label} train step: {out[label]:.3f} ms, peak {peaks[label]:.3f} GiB on {name}")
            del model, dp, step
    finally:
        dist.destroy_process_group()
    return out


def steps_of(checkout: str) -> int:
    """`chip_smoke.py --steps-of CHECKOUT`: the paths' end-to-end figures on
    the cspn_tpu_torch of CHECKOUT (a parent's or this one, "."), so that
    one harness times two trees in turns: the nyu_train b8 (float32 and
    bf16), kitti_benchmark b4 and kitti_sharded b4 (S = 2) train steps
    (train_step_ms) and their peak device memory, the two KITTI models' b4
    eval forwards and the bf16 nyu_eval b8 forward (load_server), and
    nyu_eval's and kitti_benchmark's served frames/s over SERVE_WINDOW
    requests (served_rate); where CHECKOUT has parallel/data.py, also the
    nyu_train b8 step through DDP on a 1-rank NCCL group on both reduce
    routes (`nyu_train b8 ddp sync` / `ddp bf16`, its make_train_step).
    CHECKOUT's package builds the models, data, loss, optimizer and server;
    the timing is this script's.  Prints the card line and one JSON
    object."""
    root = os.path.abspath(checkout)
    sys.path.insert(0, root)
    import cspn_tpu_torch

    if not os.path.abspath(cspn_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"cspn_tpu_torch came from {cspn_tpu_torch.__file__}, not {root}")
    from cspn_tpu_torch import set_conv_policy
    from cspn_tpu_torch.config import PRESETS
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.models.unet import cspn_unet_resnet18
    from cspn_tpu_torch.parallel import make_mesh
    from cspn_tpu_torch.serving import DepthServer, load_server
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.loss import masked_l1_loss
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.utils.profiling import calibrated_model, nyu_eval_synthetic

    name, card = torch.cuda.get_device_name(0), card_line()
    set_conv_policy("cuda")
    result = {"card": card, "package": cspn_tpu_torch.__file__, "steps_ms": {},
              "step_peak_gib": {}, "eval_forward_ms": {}, "served_frames_per_s": {}}
    kitti, nyu = _kitti_cfg(), nyu_eval_synthetic()
    nyu16 = PRESETS["nyu_train"]
    nyu16 = dataclasses.replace(nyu16, model=dataclasses.replace(nyu16.model, dtype="bfloat16"))
    # (label, the model's config, the frames' config, batch)
    for label, cfg, data, batch in (("nyu_train b8", PRESETS["nyu_train"], nyu, 8),
                                    ("nyu_train b8 bf16", nyu16, nyu, 8),
                                    ("kitti_benchmark b4", kitti, kitti, 4),
                                    ("kitti_sharded b4", kitti, kitti, 4)):
        ds = SyntheticDepthDataset(length=batch, hw=tuple(data.data.crop_hw),
                                   n_sample=data.data.n_sample, seed=1)
        x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(batch)])).cuda()
        depth = torch.from_numpy(np.stack([ds[i]["depth"] for i in range(batch)])).cuda()
        model = build_model(cfg, train=True, device="cuda", seed=0)
        if label.startswith("kitti_sharded"):
            sharded = cspn_unet_resnet18(cspn_steps=cfg.model.cspn_steps,
                                         cspn_norm_type=cfg.model.cspn_norm_type,
                                         spatial_mesh=make_mesh(spatial=2)).cuda()
            sharded.load_state_dict(model.state_dict())
            model = sharded.train()
        torch.cuda.reset_peak_memory_stats()
        ms = train_step_ms(model, make_optimizer(model.parameters()), masked_l1_loss, x, depth)
        peak = torch.cuda.max_memory_allocated() / 2**30
        result["steps_ms"][label] = ms
        result["step_peak_gib"][label] = peak
        log(f"  {label} train step: {ms:.3f} ms, peak {peak:.3f} GiB on {name}")
        if label.startswith("kitti"):  # the eval forward, no backward following
            model.eval()
            with torch.inference_mode():
                result["eval_forward_ms"][label] = time_ms(lambda: model(x), reps=11, warmup=2)
            log(f"  {label} eval forward: {result['eval_forward_ms'][label]:.3f} ms on {name}")
        del model, x, depth
    if importlib.util.find_spec("cspn_tpu_torch.parallel.data") is not None:
        result["steps_ms"].update(ddp_steps_ms(name, result["step_peak_gib"]))
    # the bf16 nyu_eval b8 forward of the served model (load_server's bf16 cast)
    ds = SyntheticDepthDataset(length=8, hw=tuple(nyu.data.crop_hw), n_sample=nyu.data.n_sample,
                               seed=1, split="val")
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(8)])).cuda()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as ckpt_dir:
        torch.save(calibrated_model(nyu, calib_batch=8).state_dict(),
                   os.path.join(ckpt_dir, "best_model.pt"))
        srv = load_server(dataclasses.replace(nyu, best_model_dir=ckpt_dir), buckets=(8,),
                          device="cuda", int8_from=None)
    with torch.inference_mode():
        ms = time_ms(lambda: srv.models["bf16"](x), reps=11, warmup=2)
    result["eval_forward_ms"]["nyu_eval b8 bf16"] = ms
    log(f"  nyu_eval b8 bf16 eval forward: {ms:.3f} ms on {name}")
    del srv, x
    for label, cfg, buckets, sizes in (("nyu_eval", nyu, BUCKETS, REQUESTS),
                                       ("kitti_benchmark", kitti, KITTI_BUCKETS, KITTI_REQUESTS)):
        h, w = cfg.data.crop_hw
        srv = DepthServer(calibrated_model(cfg, calib_batch=buckets[-1]), buckets)
        srv.warmup(h, w)
        ds = SyntheticDepthDataset(length=sum(sizes), hw=(h, w), n_sample=cfg.data.n_sample,
                                   seed=1, split="val")
        starts = np.cumsum((0,) + sizes)
        reqs = [np.stack([ds[i]["rgbd"] for i in range(a, b)]) for a, b in zip(starts, starts[1:])]
        result["served_frames_per_s"][label] = served_rate(srv, reqs, name)
        del srv
    print(card, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def paddle_inputs(gen, n, h, w, c, channel_first=False):
    """Raw guidance [n,h,w,8c] (zero in one corner: centre weight 1 there)
    and features [n,h,w,c] for cspn_nd's 2D branch; [n,8c,h,w] and
    [n,c,h,w] with channel_first."""
    guide = torch.randn(n, h, w, 8 * c, device="cuda", generator=gen)
    guide[0, :3, :4] = 0.0
    feat = torch.randn(n, h, w, c, device="cuda", generator=gen)
    if channel_first:
        return guide.movedim(-1, 1).contiguous(), feat.movedim(-1, 1).contiguous()
    return guide, feat


# the paddle kernel's launch splits (12 steps a launch)
PADDLE_SPLITS = (0, 1, 11, 12, 13, STEPS)


def check_paddle2d_kernel(name: str) -> dict:
    """Phase 3: the paddle 2D kernel, through cspn2d_paddle_cuda (the raw
    guide in cspn_nd's layout, autograd of the plain version for the
    backward), against its plain version (cspn_nd_reference) in both
    layouts at each case, forward and gradients under a random cotangent;
    its CUDA launches a call counted from the host's records at the launch
    splits; then timed at each case's maps (CUDA events around one call,
    and queued): the kernel and cspn_nd's whole 2D forward."""
    from cspn_tpu_torch.ops import cspn_paddle2d_cuda as p2
    from cspn_tpu_torch.ops.cspn import cspn_nd

    gen = torch.Generator(device="cuda").manual_seed(7)
    max_err = 0.0
    times = []
    for n, h, w, c in PADDLE_CASES:
        for cf in (False, True):
            guide, feat = paddle_inputs(gen, n, h, w, c, cf)
            ct = torch.randn(feat.shape, device="cuda", generator=gen)
            outs = {}
            for label, fn in (("kernel", p2.cspn2d_paddle_cuda), ("plain", p2.paddle2d_reference)):
                gd, ft = guide.clone().requires_grad_(True), feat.clone().requires_grad_(True)
                out = fn(gd, ft, steps=STEPS, channel_first=cf)
                outs[label] = (out, *torch.autograd.grad(out, (gd, ft), ct))
            torch.cuda.synchronize()
            layout = "channel-first" if cf else "channel-last"
            for what, a, x in zip(("out", "d guide", "d feat"), outs["kernel"], outs["plain"]):
                max_err = max(max_err, _check_close(
                    f"paddle2d [{n},{h},{w}] C={c} {layout} steps={STEPS} {what}", a, x))
        guide, feat = paddle_inputs(gen, n, h, w, c)
        if (n, h, w, c) == PADDLE_CASES[0]:
            for k in PADDLE_SPLITS:
                launches_per_call(lambda: p2._launch(guide, feat, k), ("paddle2d",),
                                  p2.cuda_launches(k), f"paddle2d at steps={k}")
        paddle = lambda: p2._launch(guide, feat, STEPS)  # noqa: E731

        def forward():
            with torch.no_grad():
                return cspn_nd(guide, feat, steps=STEPS)

        counted, _ = launches_per_call(forward, ("paddle2d",), p2.cuda_launches(STEPS),
                                       f"cspn_nd 2D forward [{n},{h},{w}] C={c}")
        ms, queued_ms = time_ms(paddle), time_queued_ms(paddle)
        fwd_ms, fwd_queued_ms = time_ms(forward), time_queued_ms(forward)
        plain_ms = time_ms(lambda: p2.paddle2d_reference(guide, feat, steps=STEPS), reps=5, warmup=1)
        px = n * c * h * w
        # read 8 gates + x0, write 1; 8 FMA + the centre product per step, the normalization once
        bound_ms, bound_by, bytes_ms, ops_ms = bound(name, 10 * px * 4, (17 * STEPS + 26) * px)
        log(f"  paddle2d [{n * c},8,{h},{w}] steps={STEPS}: kernel {ms:.4f} ms ({queued_ms:.4f} "
            f"queued), cspn_nd's 2D forward {fwd_ms:.4f} ({fwd_queued_ms:.4f}; "
            f"{counted} CUDA launches), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
            f"{bytes_ms:.4f} ms, operations {ops_ms:.4f} ms) on {name}")
        times.append({"ms": ms, "queued_ms": queued_ms, "cspn_nd_ms": fwd_ms,
                      "cspn_nd_queued_ms": fwd_queued_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
    main = times[0]  # the demo's maps: the main path's shape
    return {
        "name": "paddle2d",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/paddle2d.cu",
        "replaces": "cspn_tpu/ops/cspn_pallas.py:666",
        "launches": None,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a 24-step CSPN
        "queued_ms": main["queued_ms"],
        "cuda_launches_per_call": p2.cuda_launches(STEPS),
        "by_case": {"x".join(map(str, case)): t for case, t in zip(PADDLE_CASES, times)},
    }


def check_step_probe(name: str) -> dict:
    """Phase 3: the step-body probe against its plain version for each
    dtype pair, a few iterations on one block per SM; then one launch of
    PROBE_ROW_ITERS iterations (f32 / f32) timed (CUDA events around one
    call, and queued) beside the plain version."""
    from cspn_tpu_torch.utils import step_probe

    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    max_err = 0.0
    for gd, sd in step_probe.PAIRS:
        g, x = step_probe.probe_inputs(blocks, gd, sd, device="cuda")
        got = step_probe.step_probe(g, x, PROBE_CHECK_ITERS).float()
        want = step_probe.step_probe_ref(g, x, PROBE_CHECK_ITERS).float()
        torch.cuda.synchronize()
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        tol = PROBE_TOL[sd]
        log(f"  step_probe {gd}/{sd} [{blocks},8,8,512] iters={PROBE_CHECK_ITERS}: max|err| = {err:.3e} "
            f"(max|plain| = {scale:.3e}, tol {tol:g} x max|plain|)")
        if not (err <= tol * scale) or not torch.isfinite(got).all():
            raise AssertionError(f"step_probe {gd}/{sd}: max|err| {err:.3e} > {tol * scale:.3e}")
        if sd == torch.float32:
            max_err = max(max_err, err)
    g, x = step_probe.probe_inputs(blocks, torch.float32, torch.float32, device="cuda")
    probe = lambda: step_probe._launch(g, x, PROBE_ROW_ITERS)  # noqa: E731
    ms, queued_ms = time_ms(probe), time_queued_ms(probe)
    plain_ms = time_ms(lambda: step_probe.step_probe_ref(g, x, PROBE_ROW_ITERS), reps=5, warmup=1)
    px = x.numel()
    # read 8 gate planes + state, write the state; 16 flops a px-iteration
    bound_ms, bound_by, bytes_ms, ops_ms = bound(
        name, 10 * px * 4, step_probe.FLOPS_PER_PX_ITER * PROBE_ROW_ITERS * px)
    log(f"  step_probe f32/f32 [{blocks},8,8,512] iters={PROBE_ROW_ITERS}: kernel {ms:.4f} ms "
        f"({queued_ms:.4f} queued), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms, operations "
        f"{ops_ms:.4f} ms) on {name}")
    return {
        "name": "step_probe",
        "route": "cuda",
        "source": "cspn_tpu_torch/csrc/step_probe.cu",
        "replaces": "scripts/vpu_probe.py:49",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # a microprobe: no PyTorch call computes its loop
        "queued_ms": queued_ms,
    }


def plain_halo_vjp(gates, base, keep, x, ct, k):
    """The segment backward's plain version: autograd of the plain segment."""
    from cspn_tpu_torch.ops import cspn_ref

    ts = [None if t is None else t.detach().requires_grad_(True) for t in (gates, base, keep, x)]
    out = cspn_ref.halo_segment_reference(*ts, k)
    return torch.autograd.grad(out, [t for t in ts if t is not None], ct)


def segment_fixed_s(k_hi: int = 6, steps: int = 24, reps: int = 20) -> float:
    """The host time of one segment of cspn2d_spatial beyond its stencil
    work (the halo exchange, the wrapper, the launches): the two-point slope
    between halo 1 (24 segments) and halo 6 (4 segments) on a tiny
    in-process S = 2 map, where the stencil costs next to nothing."""
    from cspn_tpu_torch.parallel import cspn2d_spatial, make_mesh

    gen = torch.Generator(device="cuda").manual_seed(12)
    g, b, s = cspn_inputs(gen, 1, 16, 32, True)
    mesh = make_mesh(spatial=2)
    per_call = {}
    for k in (1, k_hi):
        with torch.no_grad():
            cspn2d_spatial(g, b, s, mesh=mesh, steps=steps, halo=k, channel_first=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                cspn2d_spatial(g, b, s, mesh=mesh, steps=steps, halo=k, channel_first=True)
            torch.cuda.synchronize()
        per_call[k] = (time.perf_counter() - t0) / reps
    return (per_call[1] - per_call[k_hi]) / (steps - -(-steps // k_hi))


def halo_seg_cases() -> list[tuple]:
    """The segment kernels' (S, batch, halo, with_sparse) on the paths that
    run them: kitti_sharded's eval b1 and b4 and b4 train step (S = 2, the
    cost model's K, with sparse) and phase 11's op check (b4, S = 2 and 4,
    the cost model's K and HALO_K, with and without sparse)."""
    return [(2, 1, None, True)] + list(itertools.product(SPATIAL, (KITTI_SHAPE[0],),
                                                         (None, HALO_K), (True, False)))


def plain_segment_states(gates, base, keep, x, k):
    """x_1..x_{k-1} of the plain segment (halo_segment_reference one step
    at a time, which is the same loop), stacked [k-1, n, He, W]: the states
    the forward that a backward follows keeps."""
    from cspn_tpu_torch.ops import cspn_ref

    states = []
    for _ in range(k - 1):
        x = cspn_ref.halo_segment_reference(gates, base, keep, x, 1)
        states.append(x)
    return torch.stack(states) if states else x.new_empty((0, *x.shape))


def check_halo_seg_kernels(name: str) -> list[dict]:
    """Phase 3: the sharded CSPN's segment kernels (cspn2d_halo_seg, both
    routes, and its backward) against the plain segment and its autograd
    under a random cotangent, on the inputs that cspn2d_spatial hands its
    first segment (parallel/halo.py:first_segment_inputs; the in-process
    mesh stacks the S blocks along the batch) at every (shape, K, keep) of
    halo_seg_cases: the forward that no backward follows and the one that
    keeps its states equal value for value, every kept state x_t within
    KERNEL_TOL of the plain segment's, the backward through
    cspn2d_halo_segment (the states route, then the backward on its kept
    states) against plain autograd, and each call's CUDA launches counted
    by torch.profiler and held to ops/cspn_halo_cuda.py:cuda_launches
    (ceil(K / 12) forward, 3 backward at K = 24 with keep); then at
    kitti_sharded's b4 train shape a second backward held bit for bit to
    the first, the launches also at SEG_BWD_SPLITS with and without keep,
    and each kernel timed (CUDA events and queued), with the cost model's
    per-pixel-step time and fixed cost per segment
    (parallel/halo.py:choose_halo)."""
    from cspn_tpu_torch.ops import cspn_halo_cuda, cspn_ref
    from cspn_tpu_torch.parallel import halo, make_mesh

    gen = torch.Generator(device="cuda").manual_seed(10)
    _, h, w = KITTI_SHAPE
    max_err = {"cspn2d_halo_seg": 0.0, "cspn2d_halo_seg_bwd": 0.0}

    def count_launches(gates, base, keep, x, ct, k, what) -> tuple[int, int, int]:
        """The CUDA launches of each route and the backward, each held to cuda_launches."""
        fwd, bwd = cspn_halo_cuda.cuda_launches(k, keep is not None)
        kept = cspn_halo_cuda._launch(gates, base, keep, x, k, keep_states=True)[1:]
        return (launches_per_call(lambda: cspn_halo_cuda._launch(gates, base, keep, x, k),
                                  ("halo_seg_kernel",), fwd, f"cspn2d_halo_seg {what}")[0],
                launches_per_call(lambda: cspn_halo_cuda._launch(gates, base, keep, x, k,
                                                                 keep_states=True),
                                  ("halo_seg_kernel",), fwd,
                                  f"cspn2d_halo_seg keeping its states {what}")[0],
                launches_per_call(lambda: cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k, kept),
                                  HALO_SEG_BWD_KERNELS, bwd, f"cspn2d_halo_seg_bwd {what}")[0])

    seen, timed_inputs = set(), None
    for spatial, batch, halo_k, with_sparse in halo_seg_cases():
        g, b, sp = cspn_inputs(gen, batch, h, w, with_sparse, negative=0.2)
        with torch.no_grad():
            *inputs, k = halo.first_segment_inputs(g, b, sp, mesh=make_mesh(spatial=spatial),
                                                   steps=STEPS, halo=halo_k, channel_first=True)
        del g, b, sp
        n, _, he, _ = inputs[0].shape
        if (spatial, batch, halo_k, with_sparse) == (2, KITTI_SHAPE[0], None, True):
            timed_inputs = (inputs, k)  # kitti_sharded's b4 train step
        if (n, he, k, with_sparse) in seen:
            continue
        seen.add((n, he, k, with_sparse))
        ct = torch.randn(n, he, w, device="cuda", generator=gen)
        label = (f"[{n},8,{he},{w}] (S={spatial}, b{batch}) K={k} "
                 f"{'with' if with_sparse else 'without'} keep")
        counted = count_launches(*inputs, ct, k, label)
        label += f", {counted[0]} / {counted[2]} CUDA launches"
        # the two forward routes, and every state the second keeps
        out = cspn_halo_cuda._launch(*inputs, k)
        out_kept, _, states = cspn_halo_cuda._launch(*inputs, k, keep_states=True)
        torch.cuda.synchronize()
        if not torch.equal(out, out_kept):
            raise AssertionError(f"cspn2d_halo_seg {label}: the route keeping its states differs "
                                 "from the one that does not")
        want_states = plain_segment_states(*inputs, k)
        states_err = max((_check_close(f"cspn2d_halo_seg {label} x_{t + 1}", states[t],
                                       want_states[t], quiet=True)
                          for t in range(k - 1)), default=0.0)
        del out, out_kept, states, want_states
        # through cspn2d_halo_segment: the states route, then the backward on its states
        ts = [None if t is None else t.clone().requires_grad_(True) for t in inputs]
        before = (cspn_halo_cuda.launches, cspn_halo_cuda.bwd_launches)
        got = cspn_halo_cuda.cspn2d_halo_segment(*ts, k)
        got_grads = torch.autograd.grad(got, [t for t in ts if t is not None], ct)
        want = cspn_ref.halo_segment_reference(*inputs, k)
        want_grads = plain_halo_vjp(*inputs, ct, k)
        torch.cuda.synchronize()
        if (cspn_halo_cuda.launches - before[0], cspn_halo_cuda.bwd_launches - before[1]) != (1, 1):
            raise AssertionError(f"cspn2d_halo_segment {label}: not one run of each kernel")
        max_err["cspn2d_halo_seg"] = max(max_err["cspn2d_halo_seg"], states_err,
                                         _check_close(f"cspn2d_halo_seg {label}", got, want))
        names = ("d gates", "d base") + (("d keep",) if with_sparse else ()) + ("d x",)
        for what, a, e in zip(names, got_grads, want_grads):
            max_err["cspn2d_halo_seg_bwd"] = max(max_err["cspn2d_halo_seg_bwd"], _check_close(
                f"cspn2d_halo_seg_bwd {label} {what}", a, e))
        log(f"  cspn2d_halo_seg {label}: both routes equal, the {k - 1} kept states within tol "
            f"(max|err| {states_err:.3e})")
        del got, got_grads, want, want_grads, ts, inputs

    (gates, base, keep, x), k = timed_inputs
    n, _, he, _ = gates.shape
    ct = torch.randn(n, he, w, device="cuda", generator=gen)
    px = n * he * w
    kept = cspn_halo_cuda._launch(gates, base, keep, x, k, keep_states=True)[1:]
    first = cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k, kept)
    second = cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k, kept)
    if not all(torch.equal(a, e) for a, e in zip(first, second)):
        raise AssertionError("cspn2d_halo_seg_bwd: a second backward differs from the first")
    del first, second
    # the launch splits: one launch of a step, of 11 and 12 (one of each
    # kind), 13 (a ragged second), with and without keep (the epilogue)
    split_launches = {}
    for k_split in SEG_BWD_SPLITS:
        for keep_split in (keep, None):
            what = f"K={k_split} {'with' if keep_split is not None else 'without'} keep"
            split_launches[what] = count_launches(gates, base, keep_split, x, ct, k_split, what)
    log(f"  cspn2d_halo_seg [{n},8,{he},{w}]: CUDA launches a call by torch.profiler (forward, "
        f"forward keeping its states, backward) {split_launches}, each as cuda_launches gives on "
        f"{name}")
    fwd_launches, _, bwd_launches = count_launches(gates, base, keep, x, ct, k, f"at K={k}")
    found = kernel_profile(lambda: cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k, kept),
                           HALO_SEG_BWD_KERNELS)[1]
    bwd_split = {key: v["ms"] for key, v in found.items()}  # reverse tiles, epilogue
    fwd = lambda: cspn_halo_cuda._launch(gates, base, keep, x, k)  # noqa: E731
    fwd_kept = lambda: cspn_halo_cuda._launch(gates, base, keep, x, k, keep_states=True)  # noqa: E731
    bwd = lambda: cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k, kept)  # noqa: E731
    timed = {
        "cspn2d_halo_seg": (
            fwd, lambda: cspn_ref.halo_segment_reference(gates, base, keep, x, k),
            # read 8 gates, base, keep, x; write 1; 8 FMA + the keep product
            # and the base add per pixel per step; keeping its states it
            # also writes the K - 1 states and the 8 folded gates
            12, 12 + k - 1 + 8, 18 * k * px, 290, fwd_launches),
        "cspn2d_halo_seg_bwd": (
            bwd, lambda: plain_halo_vjp(gates, base, keep, x, ct, k),
            # read 8 gates, base, keep, x, cotangent; write 8 + 3; the
            # reverse step's 33 flops, the epilogue's 24; on the kept
            # states it reads G and the K - 1 states, not base
            23, 23 - 1 + 8 + k - 1, (33 * k + 24) * px, 398, bwd_launches),
    }
    rows = []
    for kname, (fn, plain, planes, kept_planes, ops, tpu_line, cuda_launches) in timed.items():
        ms, queued_ms = time_ms(fn), time_queued_ms(fn)
        plain_ms = time_ms(plain)
        bound_ms, bound_by, bytes_ms, ops_ms = bound(name, planes * px * 4, ops)
        kept_bound_ms = bound(name, kept_planes * px * 4, ops)[0]
        log(f"  {kname} [{n},8,{he},{w}] K={k} with keep ({cuda_launches} CUDA launches, counted by "
            f"torch.profiler): kernel {ms:.4f} ms ({queued_ms:.4f} queued), plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f} ms: {planes} planes; operations "
            f"{ops_ms:.4f} ms), with the kept states and folded gates ({kept_planes} planes) "
            f"{kept_bound_ms:.4f} ms on {name}")
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": f"cspn_tpu_torch/csrc/{kname}.cu",
            "replaces": f"cspn_tpu/ops/cspn_pallas.py:{tpu_line}",
            "launches": None,
            "max_abs_err": max_err[kname],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes a CSPN segment
            "queued_ms": queued_ms,
            "kept_bound_ms": kept_bound_ms,
            "timed_shape": [n, 8, he, w],
            "timed_k": k,
            "cuda_launches_per_segment": cuda_launches,
        })
    rows[0]["kept_ms"], rows[0]["kept_queued_ms"] = time_ms(fwd_kept), time_queued_ms(fwd_kept)
    log(f"  cspn2d_halo_seg keeping its states: {rows[0]['kept_ms']:.4f} ms "
        f"({rows[0]['kept_queued_ms']:.4f} queued) on {name}")
    rows[1]["split_ms"] = bwd_split
    rows[1]["cuda_launches_at_splits"] = split_launches
    log(f"  cspn2d_halo_seg_bwd: a second backward bit for bit the first; its launches by "
        f"torch.profiler, ms a call: {bwd_split} on {name}")
    # the cost model's constants (parallel/halo.py), measured here
    rows[0]["ps_per_px_step"] = rows[0]["ms"] * 1e9 / (k * px)
    rows[0]["segment_fixed_us"] = segment_fixed_s() * 1e6
    log(f"  choose_halo's constants: the forward segment {rows[0]['ps_per_px_step']:.4f} ps per "
        f"pixel-step at K={k}; {rows[0]['segment_fixed_us']:.2f} us of host time per segment "
        f"beyond its stencil (in-process S=2, [1,16,32]) on {name}")
    return rows


# serving.py:LAUNCH_COUNTERS by the kernels line's names
COUNTER_KERNELS = {("cspn_tpu_torch.ops.cspn_cuda", "launches"): "cspn2d_fwd",
                   ("cspn_tpu_torch.ops.cspn_cuda", "tiled_launches"): "cspn2d_tiled",
                   ("cspn_tpu_torch.ops.cspn_cuda", "bwd_launches"): "cspn2d_bwd",
                   ("cspn_tpu_torch.ops.d2s", "launches"): "d2s",
                   ("cspn_tpu_torch.ops.d2s", "bwd_launches"): "s2d",
                   ("cspn_tpu_torch.ops.cspn_halo_cuda", "launches"): "cspn2d_halo_seg",
                   ("cspn_tpu_torch.ops.cspn_halo_cuda", "bwd_launches"): "cspn2d_halo_seg_bwd"}
GRAPH_WINDOW = 16  # requests of a bucket's served-rate window, graphed and eager in turns
GRAPH_REPLAYS = 5  # replays a torch.profiler session counts the kernels of


def graph_memory(srv) -> str:
    """The device memory of a server's graph pool (serving.py: one pool for
    every bucket's graph), from the caching allocator's segments: what it
    reserves and what is allocated in it (the graphs' static outputs)."""
    pool = tuple(srv._pool)
    segs = [seg for seg in torch.cuda.memory_snapshot() if tuple(seg.get("segment_pool_id", ())) == pool]
    reserved = sum(seg["total_size"] for seg in segs) / 2**30
    alloc = sum(seg.get("allocated_size", 0) for seg in segs) / 2**30
    return (f"the graphs' pool reserves {reserved:.3f} GiB in {len(segs)} segments, {alloc:.3f} "
            "GiB of it allocated")


def path_label(srv, bucket: int) -> str:
    """The bucket's path, or the one model's where the server has one."""
    if srv.models["int8"] is not None:
        return srv.path_for(bucket)
    model = srv.models["bf16"]
    return "int8" if getattr(model, "quant", False) else \
        str(next(model.parameters()).dtype).removeprefix("torch.")


def replay_records(graph, keys, reps: int = GRAPH_REPLAYS) -> dict:
    """torch.profiler's device kernel records over `reps` replays of a
    CUDA graph: {key: records of kernels whose name holds it}.  (A replay
    is one cudaGraphLaunch on the host, so only the card's records count
    its kernels; they can lose a session's first ones, kernel_profile.)"""
    from torch.profiler import ProfilerActivity, profile

    graph.replay()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    found = dict.fromkeys(keys, 0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for key in keys:
                if key in e.key:
                    found[key] += e.count
    return found


def check_graphed(label: str, srv, eager, reqs, frames, name: str) -> None:
    """Phases 4 and 13: `srv` serves each bucket by replaying its CUDA
    graph, `eager` (cuda_graphs=False) the same models eagerly.  Every
    request's output equal bit for bit; each bucket's launches a replay
    (what its capture counted) equal to one forward's (the tiled 2D CSPN
    once, `d2s` d2s_per_forward times), and torch.profiler's device records
    over GRAPH_REPLAYS replays holding those kernels' CUDA launches
    (ops/cspn_cuda.py:cuda_launches_per_call, one a `d2s`); then
    time_graphed."""
    from cspn_tpu_torch.ops.cspn_cuda import cuda_launches_per_call

    for r in reqs:
        got, want = srv.predict(r), eager.predict(r)
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: request of {len(r)} graphed vs eager: max|err| "
                                 f"{np.abs(got - want).max():.3e}, not bit for bit")
    log(f"  {label}: graphed = eager bit for bit on requests {tuple(len(r) for r in reqs)}")
    keys = ("cspn2d_tiled_kernel", "d2s_kernel")
    # the int8 model's subpixel convs are QuantConvs: count the bf16 model's
    want = {"cspn2d_tiled": 1, "d2s": d2s_per_forward(srv.models["bf16"])}
    for (b, h, w), g in sorted(srv.graphs.items()):
        model = srv.models[srv.path_for(b)]
        per = {COUNTER_KERNELS[k]: v for k, v in g.launches.items() if v}
        if per != want:
            raise AssertionError(f"{label} bucket {b}: a replay counts {per}, a forward {want}")
        cuda = dict(zip(keys, (cuda_launches_per_call(model.cspn_steps)["cspn2d_tiled"],
                               want["d2s"])))
        rec = replay_records(g.graph, keys)
        for k, n in cuda.items():  # short by less than a replay: the session's first records lost
            if not GRAPH_REPLAYS * n - n < rec[k] <= GRAPH_REPLAYS * n:
                raise AssertionError(f"{label} bucket {b}: torch.profiler recorded {rec[k]} {k} "
                                     f"over {GRAPH_REPLAYS} replays, {n} a replay expected")
        log(f"    bucket {b} ({path_label(srv, b)}): a replay counts {per}; torch.profiler over "
            f"{GRAPH_REPLAYS} replays recorded {rec} (a replay: {cuda})")
    time_graphed(srv, eager, frames, name)


def time_graphed(srv, eager, frames, name: str) -> None:
    """In turns (graphed, eager, eager, graphed), each of `srv`'s buckets:
    the forward by CUDA events (a replay of its graph against `eager`'s
    model call) and served frames/s over GRAPH_WINDOW requests of the
    bucket's size (rows of `frames`) by the host clock."""
    with torch.inference_mode():
        for (b, h, w), g in sorted(srv.graphs.items()):
            model, req = srv.models[srv.path_for(b)], frames[:b]
            x = torch.from_numpy(req).cuda()
            fwd, fps = {"graphed": [], "eager": []}, {"graphed": [], "eager": []}
            for kind in ("graphed", "eager", "eager", "graphed"):
                server = srv if kind == "graphed" else eager
                fwd[kind].append(time_ms(g.graph.replay if kind == "graphed" else lambda: model(x),
                                         reps=5, warmup=1))
                t0 = time.perf_counter()
                for _ in range(GRAPH_WINDOW):
                    server.predict(req)
                fps[kind].append(b * GRAPH_WINDOW / (time.perf_counter() - t0))
            log(f"    bucket {b} ({path_label(srv, b)}), graphed / eager in turns (G, E, E, G): "
                f"forward {' / '.join(f'{t:.3f}' for t in fwd['graphed'])} ms graphed, "
                f"{' / '.join(f'{t:.3f}' for t in fwd['eager'])} ms eager (CUDA events); served "
                f"{' / '.join(f'{t:.2f}' for t in fps['graphed'])} frames/s graphed, "
                f"{' / '.join(f'{t:.2f}' for t in fps['eager'])} eager ({GRAPH_WINDOW} requests of "
                f"{b}, host clock) on {name}")


def served_rate(srv, reqs, name: str) -> float:
    """Frames/s of SERVE_WINDOW requests to `srv`, cycling through `reqs`,
    by the host's clock (DepthServer.predict returns host arrays, so each
    request ends synchronized)."""
    frames = 0
    t0 = time.perf_counter()
    for i in range(SERVE_WINDOW):
        frames += len(srv.predict(reqs[i % len(reqs)]))
    elapsed = time.perf_counter() - t0
    log(f"  served rate: {SERVE_WINDOW} requests cycling through sizes "
        f"{tuple(len(r) for r in reqs)}, {frames} frames in {elapsed:.4f} s = "
        f"{frames / elapsed:.2f} frames/s, {SERVE_WINDOW / elapsed:.2f} requests/s on {name}")
    return frames / elapsed


def serve_slice(name: str) -> dict:
    """Phase 4: the nyu_eval model served through DepthServer; returns each
    kernel's launches during the served requests."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.serving import DepthServer, chunk_plan
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.metrics import ErrorAverager, evaluate_error
    from cspn_tpu_torch.utils.profiling import calibrated_model, decoder_twin, nyu_eval_synthetic

    cfg = nyu_eval_synthetic()
    h, w = cfg.data.crop_hw
    log(f"  model {cfg.model.arch}, cspn steps {cfg.model.cspn_steps}, "
        f"norm {cfg.model.cspn_norm_type}, {cfg.data.n_sample} sparse samples, {h}x{w}")
    t0 = time.perf_counter()
    model = calibrated_model(cfg)
    if not model.subpixel:
        raise AssertionError("nyu_eval's model must run the subpixel decoder (the default)")
    ref_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_backend="reference"))
    model_ref = build_model(ref_cfg, train=False, device="cuda", seed=None)
    model_ref.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  built + calibrated {n_params / 1e6:.1f} M params in {time.perf_counter() - t0:.1f} s")

    srv, srv_ref = DepthServer(model, BUCKETS), DepthServer(model_ref, BUCKETS, cuda_graphs=False)
    t0 = time.perf_counter()
    srv.warmup(h, w)  # captures each bucket's graph
    log(f"  warmup captured {len(srv.graphs)} graphs (buckets {BUCKETS}) in "
        f"{time.perf_counter() - t0:.1f} s; {graph_memory(srv)}")
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
    forwards = sum(len(chunk_plan(n, BUCKETS)) for n in REQUESTS)
    expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_tiled=forwards,
                    d2s=d2s_per_forward(model) * forwards)
    log(f"  served requests {REQUESTS} over buckets {BUCKETS}: {sum(REQUESTS)} frames in "
        f"{elapsed:.4f} s; launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"served run launched {launches}, expected {expected}")
    if srv.served != {"bf16": sum(REQUESTS), "int8": 0}:  # one model: DepthServer's first path
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
    served_rate(srv, reqs, name)
    check_graphed("nyu_eval float32", srv, DepthServer(model, BUCKETS, cuda_graphs=False), reqs,
                  np.stack([f["rgbd"] for f in frames[:BUCKETS[-1]]]), name)
    with torch.inference_mode():
        for b in BUCKETS:
            x = torch.from_numpy(np.stack([f["rgbd"] for f in frames[:b]])).cuda()
            fwd_ms = time_ms(lambda: model(x), reps=5, warmup=1)
            log(f"  bucket {b} forward: {fwd_ms:.3f} ms = {b * 1e3 / fwd_ms:.2f} frames/s on {name}")
        # the same weights in the plain unpool + conv decoder (JAX's
        # subpixel=False): outputs held together, the b8 forward timed in
        # turns (subpixel, plain, plain, subpixel)
        del model_ref, srv_ref
        plain = decoder_twin(model, subpixel=False)
        got, want = model(x), plain(x)
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        log(f"  b{x.shape[0]} subpixel vs plain decoder, same weights: max|err| = {err:.3e} "
            f"(max|plain| = {scale:.3e}, tol {KERNEL_TOL:g} x max|plain|)")
        if not err <= KERNEL_TOL * scale:
            raise AssertionError(f"subpixel vs plain decoder: {err:.3e} > {KERNEL_TOL * scale:.3e}")
        times = {"subpixel": [], "plain": []}
        for form in ("subpixel", "plain", "plain", "subpixel"):
            mdl = model if form == "subpixel" else plain
            times[form].append(time_ms(lambda: mdl(x), reps=5, warmup=1))
        for form, ts in times.items():
            log(f"  b{x.shape[0]} forward, {form} decoder: "
                f"{' / '.join(f'{t:.3f}' for t in ts)} ms on {name}")
        del plain
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


def check_against_oracle(kernel, plain, oracle, labels=("kernel", "plain CSPN")) -> None:
    """Raise unless a train step through the kernels agrees with the same
    step through the plain CSPN (loss within LOSS_RTOL) and each gradient
    lies within GRAD_TOL x its max of the float64 oracle's, or within
    ORACLE_FACTOR x the plain float32 step's own distance from it.  Each
    argument is (loss, {name: gradient}); `labels` name the two float32
    steps in the log."""
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
    log(f"  one train step, {labels[0]} vs {labels[1]} (deterministic cuDNN): loss {loss_k:.6f} vs "
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
    kernel's launches during the fit."""
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.factory import build_loaders
    from cspn_tpu_torch.train.loop import Trainer, make_train_step
    from cspn_tpu_torch.train.loss import masked_l1_loss
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.utils.profiling import decoder_twin, train_step_split_ms

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
        per_fwd = d2s_per_forward(trainer.state.model)
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=n_train, cspn2d_tiled=n_val,
                        cspn2d_bwd=n_train, d2s=per_fwd * (n_train + n_val), s2d=per_fwd * n_train)
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
    check_against_oracle(*(results[k] for k in ("kernel", "plain", "float64")))
    del models, results

    # the step split in both decoder forms from the same weights, in turns
    # (subpixel, plain, plain, subpixel)
    models = {"subpixel": model_k, "plain": decoder_twin(model_k, subpixel=False)}
    optimizers = {form: make_optimizer(m.parameters()) for form, m in models.items()}
    n = x.shape[0]
    for form in ("subpixel", "plain", "plain", "subpixel"):
        split = train_step_split_ms(models[form], optimizers[form], masked_l1_loss, x, depth)
        cspn_share = kernel_ms["cspn2d_train_nyu"] / split["step"]
        d2s_share = (kernel_ms["d2s"] + kernel_ms["s2d"]) / split["step"] if form == "subpixel" else 0.0
        log(f"  train step, {form} decoder (batch {n}, median of 5, CUDA events): "
            f"{split['step']:.3f} ms = {n * 1e3 / split['step']:.2f} frames/s; forward + loss "
            f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, optimizer "
            f"{split['optimizer']:.3f} ms; the 2D CSPN forward + cspn2d_bwd "
            f"{100 * cspn_share:.2f}%, d2s + s2d {100 * d2s_share:.2f}% of the step (their phase-3 "
            f"times); peak device memory "
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


def plain_stereo_twin(cfg, train: bool = False, seed=None, gate_dtype=torch.bfloat16):
    """`cfg`'s stereo model on the plain 3D CSPN reading its gates as the
    kernels do at `gate_dtype` (bf16, the kernel route's default; float32,
    the sharded segments'): the twin every stereo phase holds the kernel
    route to."""
    from cspn_tpu_torch.train.stereo_loop import build_stereo_model

    model = build_stereo_model(cfg, train=train, device="cuda", seed=seed, cspn_backend="reference")
    model.cspn_gate_dtype = gate_dtype
    return model


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
    model_ref = plain_stereo_twin(cfg)
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
    from cspn_tpu_torch.train.stereo_loop import StereoConfig, StereoTrainer, make_stereo_train_step
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
        models[label] = plain_stereo_twin(cfg, train=True).to(dtype)
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
    check_against_oracle(*(results[k] for k in ("kernel", "plain", "float64")))
    del models, results

    def loss_fn(out, d):
        return smooth_l1_disparity_loss(out, d, cfg.max_disp)

    torch.cuda.reset_peak_memory_stats()
    split = train_step_split_ms(model_k, optimizer(model_k), loss_fn, (left, right), disp)
    n = left.shape[0]
    cspn_share = (kernel_ms["cspn3d_fwd_kept"] + kernel_ms["cspn3d_bwd"]) / split["step"]
    log(f"  stereo train step (batch {n}, median of 5, CUDA events): {split['step']:.3f} ms = "
        f"{n * 1e3 / split['step']:.2f} frames/s; forward + loss {split['forward']:.3f} ms, "
        f"backward {split['backward']:.3f} ms, optimizer {split['optimizer']:.3f} ms; the two 3D "
        f"CSPN kernels {100 * cspn_share:.2f}% of the step (their phase-3 times); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {name}")
    return launches


def _kitti_cfg(save_dir: str = "", backend: str = "auto"):
    """kitti_benchmark (ResNet-18, 352x1216, 24 steps, b4 train, b1 eval)
    on the synthetic dataset at KITTI geometry."""
    from cspn_tpu_torch.utils.profiling import kitti_benchmark_synthetic

    cfg = kitti_benchmark_synthetic()
    return dataclasses.replace(cfg, save_dir=save_dir, best_model_dir=save_dir, log_every=1,
                               model=dataclasses.replace(cfg.model, cspn_backend=backend))


def kitti_serve_slice(name: str) -> dict:
    """Phase 8: kitti_benchmark served through DepthServer (buckets 1, 4) to
    requests of 1, 3 and 5 frames; returns each kernel's launches during
    the served requests."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.serving import DepthServer, chunk_plan, pick_bucket
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.utils.profiling import calibrated_model

    cfg = _kitti_cfg()
    h, w = cfg.data.crop_hw
    log(f"  model {cfg.model.arch}, cspn steps {cfg.model.cspn_steps}, norm "
        f"{cfg.model.cspn_norm_type}, {cfg.data.n_sample} sparse samples, {h}x{w}")
    t0 = time.perf_counter()
    model = calibrated_model(cfg, calib_batch=KITTI_BUCKETS[-1])
    model_ref = build_model(_kitti_cfg(backend="reference"), train=False, device="cuda", seed=None)
    model_ref.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  built + calibrated {n_params / 1e6:.1f} M params in {time.perf_counter() - t0:.1f} s")

    srv = DepthServer(model, KITTI_BUCKETS)
    srv_ref = DepthServer(model_ref, KITTI_BUCKETS, cuda_graphs=False)
    srv.warmup(h, w)
    srv_ref.warmup(h, w)
    ds = SyntheticDepthDataset(length=sum(KITTI_REQUESTS), hw=(h, w), n_sample=cfg.data.n_sample,
                               seed=1, split="val")
    frames = [ds[i] for i in range(len(ds))]
    starts = np.cumsum((0,) + KITTI_REQUESTS)
    reqs = [np.stack([f["rgbd"] for f in frames[a:b]]) for a, b in zip(starts, starts[1:])]

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [srv.predict(r) for r in reqs]
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    buckets = [pick_bucket(size, KITTI_BUCKETS) for n in KITTI_REQUESTS
               for size in chunk_plan(n, KITTI_BUCKETS)]
    expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_tiled=len(buckets),
                    d2s=d2s_per_forward(model) * len(buckets))
    log(f"  served requests {KITTI_REQUESTS} over buckets {KITTI_BUCKETS} (forwards at batches "
        f"{buckets}): {sum(KITTI_REQUESTS)} frames in {elapsed:.4f} s; launches {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"served run launched {launches}, expected {expected}")
    worst = 0.0
    for req, out in zip(reqs, outs):
        if out.shape != req.shape[:3] or not np.isfinite(out).all():
            raise AssertionError(f"bad output: shape {out.shape}, finite {np.isfinite(out).all()}")
        ref = srv_ref.predict(req)
        err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
        if not err <= KERNEL_TOL * scale:
            raise AssertionError(f"served KITTI output vs plain-CSPN server: {err:.3e} > "
                                 f"{KERNEL_TOL * scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    log(f"  outputs finite, shapes right; max|kernel - plain| / max|plain| = {worst:.3e}")
    del model_ref, srv_ref
    served_rate(srv, reqs, name)
    with torch.inference_mode():
        for b in KITTI_BUCKETS:
            x = torch.from_numpy(np.stack([f["rgbd"] for f in frames[:b]])).cuda()
            fwd_ms = time_ms(lambda: model(x), reps=5, warmup=1)
            log(f"  bucket {b} forward: {fwd_ms:.3f} ms = {b * 1e3 / fwd_ms:.2f} frames/s on {name}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def kitti_train_slice(name: str, kernel_ms: dict) -> dict:
    """Phase 9: kitti_benchmark through Trainer.fit(1) (4 train steps of b4,
    validation at b1); returns each kernel's launches during the fit."""
    from cspn_tpu_torch.data import DataLoader, SyntheticDepthDataset
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.loop import Trainer, make_train_step
    from cspn_tpu_torch.train.loss import masked_l1_loss
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.utils.profiling import train_step_split_ms

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as save_dir:
        cfg = _kitti_cfg(save_dir)
        h, w = cfg.data.crop_hw
        bs, n_sample = cfg.data.batch_size_train, cfg.data.n_sample
        train_ds = SyntheticDepthDataset(KITTI_TRAIN_FRAMES, (h, w), n_sample, seed=0, split="train")
        val_ds = SyntheticDepthDataset(KITTI_VAL_FRAMES, (h, w), n_sample, seed=0, split="val")
        train = DataLoader(train_ds, bs, shuffle=True, drop_last=True,
                           num_workers=cfg.data.num_workers)
        val = DataLoader(val_ds, cfg.data.batch_size_eval, num_workers=cfg.data.num_workers)
        log(f"  model {cfg.model.arch}, cspn steps {cfg.model.cspn_steps}, {n_sample} sparse "
            f"samples, {h}x{w}, batch {bs}, SGD lr {cfg.optim.lr} momentum {cfg.optim.momentum} "
            f"nesterov {cfg.optim.nesterov} wd {cfg.optim.weight_decay}, loss {cfg.optim.loss}")
        trainer = Trainer(cfg, train, val, device="cuda")
        n_train, n_val = len(train), len(val)
        p0 = {k: v.detach().clone() for k, v in trainer.state.model.named_parameters()}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        val_metrics = trainer.fit(1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        per_fwd = d2s_per_forward(trainer.state.model)
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=n_train, cspn2d_tiled=n_val,
                        cspn2d_bwd=n_train, d2s=per_fwd * (n_train + n_val), s2d=per_fwd * n_train)
        log(f"  Trainer.fit(1): {n_train} train steps of {bs}, {n_val} val batches of "
            f"{cfg.data.batch_size_eval} in {elapsed:.2f} s (checkpoints included); launches "
            f"{launches} (expected {expected}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if launches != expected:
            raise AssertionError(f"KITTI training launched {launches}, expected {expected}: the "
                                 "states-keeping forward and cspn2d_bwd for the train steps, the tiled "
                                 "forward for validation")
        with open(os.path.join(save_dir, "log_train.txt")) as f:
            train_row = [float(v) for v in f.read().splitlines()[-1].split()]
        if not (np.isfinite(train_row).all() and all(np.isfinite(v) for v in val_metrics.values())):
            raise AssertionError(f"non-finite metrics: train {train_row}, val {val_metrics}")
        moved = sum(not torch.equal(p, p0[k]) for k, p in trainer.state.model.named_parameters())
        if moved != len(p0):
            raise AssertionError(f"only {moved} of {len(p0)} parameter tensors moved")
        if not (trainer.ckpt.has("best_model") and trainer.ckpt.has("epoch_00")):
            raise AssertionError(f"checkpoints missing in {os.listdir(save_dir)}")
        log(f"  train MAE {train_row[5]:.4f} RMSE {train_row[4]:.4f}; val MAE "
            f"{val_metrics['MAE']:.4f} RMSE {val_metrics['RMSE']:.4f}; all {len(p0)} parameter "
            "tensors moved; best_model and epoch_00 written")
        del p0

    # one b4 train step through the kernels (cspn2d_fwd, cspn2d_bwd), the
    # plain CSPN and the plain CSPN in float64, as phase 5
    model_k = trainer.state.model
    del trainer
    x = torch.from_numpy(np.stack([train_ds[i]["rgbd"] for i in range(bs)])).cuda()
    models = {"kernel": model_k}
    for label, dtype in (("plain", torch.float32), ("float64", torch.float64)):
        models[label] = build_model(_kitti_cfg(backend="reference"), train=True, device="cuda",
                                    seed=None).to(dtype)
        models[label].load_state_dict(model_k.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(8)
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
    check_against_oracle(*(results[k] for k in ("kernel", "plain", "float64")))
    del models, results

    torch.cuda.reset_peak_memory_stats()
    split = train_step_split_ms(model_k, make_optimizer(model_k.parameters()), masked_l1_loss, x, depth)
    cspn_share = kernel_ms["cspn2d_train_kitti"] / split["step"]
    log(f"  KITTI train step (batch {bs}, median of 5, CUDA events): {split['step']:.3f} ms = "
        f"{bs * 1e3 / split['step']:.2f} frames/s; forward + loss {split['forward']:.3f} ms, "
        f"backward {split['backward']:.3f} ms, optimizer {split['optimizer']:.3f} ms; the 2D "
        f"CSPN forward + cspn2d_bwd {100 * cspn_share:.2f}% of the step (their phase-3 times); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {name}")
    return launches


def check_sharded_op(name: str) -> None:
    """Phase 11, op level: cspn2d_spatial at kitti_benchmark's b4 (24
    steps) on in-process meshes of S = 2 and 4, with the cost model's K and
    with K = 8 (three segments, two halo refreshes), both norms, with and
    without sparse, against cspn2d (the unsharded kernels), forward and
    backward under a random cotangent; exact segment-kernel launches and
    exchanges; then the sharded (each K) and unsharded forward, and forward
    + backward, timed at 8sum with sparse."""
    from cspn_tpu_torch.ops.cspn import cspn2d
    from cspn_tpu_torch.parallel import cspn2d_spatial, exchange_counts, halo, make_mesh

    gen = torch.Generator(device="cuda").manual_seed(11)
    n, h, w = KITTI_SHAPE
    zero = dict.fromkeys(KERNEL_NAMES, 0)

    def runs(mesh, halo_k, s, norm):
        return {
            "sharded": lambda g, b: cspn2d_spatial(g, b, s, mesh=mesh, steps=STEPS, norm_type=norm,
                                                   halo=halo_k, channel_first=True),
            "unsharded": lambda g, b: cspn2d(g, b, s, steps=STEPS, norm_type=norm,
                                             channel_first=True),
        }

    for spatial, halo_k, norm, with_sparse in itertools.product(
            SPATIAL, (None, HALO_K), ("8sum", "8sum_abs"), (True, False)):
        mesh = make_mesh(spatial=spatial)
        k = halo.effective_halo(halo_k, STEPS, h // spatial, w, n)
        rounds = -(-STEPS // k)
        expected = {
            "sharded": (dict(zero, cspn2d_halo_seg=rounds, cspn2d_halo_seg_bwd=rounds),
                        exchange_counts.expected_ppermutes_2d(STEPS, k, with_sparse) // 2),
            "unsharded": (dict(zero, cspn2d_fwd=1, cspn2d_bwd=1), 0),
        }
        g, b, s = cspn_inputs(gen, n, h, w, with_sparse, negative=0.2)
        ct = torch.randn(n, h, w, device="cuda", generator=gen)
        outs = {}
        for label, fn in runs(mesh, halo_k, s, norm).items():
            gk, bk = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
            reset_launches()
            out = fn(gk, bk)
            grads = torch.autograd.grad(out, (gk, bk), ct)
            torch.cuda.synchronize()
            outs[label] = (out.detach(), *grads)
            if (read_launches(), halo.exchanges) != expected[label]:
                raise AssertionError(f"{label} S={spatial} K={k}: launched {read_launches()}, "
                                     f"{halo.exchanges} exchanges; expected {expected[label]}")
        case = (f"cspn2d_spatial S={spatial} K={k} ({rounds} segments) {norm} "
                f"{'with' if with_sparse else 'without'} sparse [{n},{h},{w}]")
        for what, a, e in zip(("out", "d guidance", "d blur"), outs["sharded"], outs["unsharded"]):
            _check_close(f"{case} vs cspn2d, {what}", a, e)
        del outs

    g, b, s = cspn_inputs(gen, n, h, w, True)
    ct = torch.randn(n, h, w, device="cuda", generator=gen)

    def fwd(fn):
        with torch.no_grad():
            fn(g, b)

    def fwd_bwd(fn):
        gk, bk = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
        torch.autograd.grad(fn(gk, bk), (gk, bk), ct)

    for spatial, halo_k in itertools.product(SPATIAL, (None, HALO_K)):
        k = halo.effective_halo(halo_k, STEPS, h // spatial, w, n)
        t = {f"{label}_{kind}_ms": time_ms(lambda: run(fn), reps=5, warmup=1)
             for label, fn in runs(make_mesh(spatial=spatial), halo_k, s, "8sum").items()
             for kind, run in (("fwd", fwd), ("fwd_bwd", fwd_bwd))}
        log(f"  S={spatial} K={k} at [{n},{h},{w}], 8sum with sparse: sharded forward "
            f"{t['sharded_fwd_ms']:.4f} ms, forward + backward {t['sharded_fwd_bwd_ms']:.4f} ms; "
            f"unsharded (cspn2d_tiled; cspn2d_fwd + cspn2d_bwd) {t['unsharded_fwd_ms']:.4f} ms, "
            f"{t['unsharded_fwd_bwd_ms']:.4f} ms on {name}")
    log("  every case within tolerance; launches and exchanges exact")


def sharded_kitti_slice(name: str) -> dict:
    """Phase 11, the depth model: kitti_benchmark's ResNet-18 CSPN-UNet with
    its CSPN rows over an in-process mesh of S = 2 (CSPNUNet(spatial_mesh=)),
    against the unsharded model with the same weights: eval forwards at b1
    and b4 through make_eval_step, one b4 train step through
    make_train_step (phase 5's rule against the unsharded float32 and the
    float64 step); both timed.  Returns the kernels' launches on the
    sharded model's runs."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.models.unet import cspn_unet_resnet18
    from cspn_tpu_torch.parallel import exchange_counts, halo, make_mesh
    from cspn_tpu_torch.train.evaluate import build_model, make_eval_step
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.loss import masked_l1_loss
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.utils.profiling import calibrated_model, train_step_split_ms

    cfg = _kitti_cfg()
    h, w = cfg.data.crop_hw
    mesh = make_mesh(spatial=2)
    model = calibrated_model(cfg, calib_batch=KITTI_BUCKETS[-1])
    sharded = cspn_unet_resnet18(cspn_steps=cfg.model.cspn_steps,
                                 cspn_norm_type=cfg.model.cspn_norm_type, spatial_mesh=mesh).cuda()
    sharded.load_state_dict(model.state_dict())
    sharded.eval()
    per_fwd = d2s_per_forward(sharded)
    ds = SyntheticDepthDataset(length=KITTI_BUCKETS[-1], hw=(h, w), n_sample=cfg.data.n_sample,
                               seed=3, split="val")
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(len(ds))])).cuda()
    gt = torch.from_numpy(np.stack([ds[i]["depth"] for i in range(len(ds))])).cuda()
    total = dict.fromkeys(KERNEL_NAMES, 0)

    def expect(launches, pairs, want, k, label):
        want = dict(dict.fromkeys(KERNEL_NAMES, 0), **want)
        want_pairs = exchange_counts.expected_ppermutes_2d(STEPS, k, True) // 2
        log(f"  {label}: launches {launches}, {pairs} exchanges (expected {want}, {want_pairs})")
        if launches != want or pairs != want_pairs:
            raise AssertionError(f"{label}: launched {launches}, {pairs} exchanges")
        for kname, v in launches.items():
            total[kname] += v

    step_s, step_u = make_eval_step(sharded), make_eval_step(model)
    for b in KITTI_BUCKETS:
        k = halo.effective_halo(None, STEPS, h // 2, w, b)
        rounds = -(-STEPS // k)
        torch.cuda.synchronize()
        reset_launches()
        got = step_s(x[:b], gt[:b])[0]
        torch.cuda.synchronize()
        expect(read_launches(), halo.exchanges, {"cspn2d_halo_seg": rounds, "d2s": per_fwd}, k,
               f"sharded eval b{b} (K={k})")
        want = step_u(x[:b], gt[:b])[0]
        if got.shape != (b, h, w) or not torch.isfinite(got).all():
            raise AssertionError(f"sharded eval b{b}: shape {tuple(got.shape)} or non-finite")
        _check_close(f"sharded vs unsharded eval forward b{b}", got, want)
    with torch.inference_mode():
        fwd = {label: time_ms(lambda: m(x), reps=5, warmup=1)
               for label, m in (("sharded", sharded), ("unsharded", model),
                                ("unsharded again", model), ("sharded again", sharded))}
    log(f"  b{len(x)} eval forward, sharded (S=2) / unsharded: " + ", ".join(
        f"{label} {ms:.3f} ms" for label, ms in fwd.items()) + f" on {name}")

    # one b4 train step: sharded, unsharded float32, unsharded float64 (the
    # oracle), from the same weights, deterministic cuDNN, the ground truth
    # 1 to 2 from each prediction (phase 9)
    models = {"kernel": sharded, "plain": build_model(cfg, train=True, device="cuda", seed=None),
              "float64": build_model(_kitti_cfg(backend="reference"), train=True, device="cuda",
                                     seed=None).to(torch.float64)}
    for m in models.values():
        m.load_state_dict(model.state_dict())
        m.train()
    del model
    gen = torch.Generator(device="cuda").manual_seed(13)
    results = {}
    k = halo.effective_halo(None, STEPS, h // 2, w, len(x))
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            pred = sharded(x)
        side = torch.where(torch.rand(pred.shape, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
        depth = pred + side * (1.0 + torch.rand(pred.shape, device="cuda", generator=gen))
        for label, m in models.items():
            dt = next(m.parameters()).dtype
            step = make_train_step(m, make_optimizer(m.parameters()))
            torch.cuda.synchronize()
            reset_launches()
            loss, _ = step(x.to(dt), depth.to(dt))
            torch.cuda.synchronize()
            if label == "kernel":
                rounds = -(-STEPS // k)
                expect(read_launches(), halo.exchanges,
                       {"cspn2d_halo_seg": rounds, "cspn2d_halo_seg_bwd": rounds, "d2s": per_fwd,
                        "s2d": per_fwd}, k, f"sharded train step b{len(x)} (K={k})")
            results[label] = (loss.item(), {n_: p.grad for n_, p in m.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = False
    check_against_oracle(results["kernel"], results["plain"], results["float64"])
    del models["float64"], results
    for label in ("sharded", "unsharded", "unsharded", "sharded"):
        m = models["kernel" if label == "sharded" else "plain"]
        split = train_step_split_ms(m, make_optimizer(m.parameters()), masked_l1_loss, x, depth)
        log(f"  b{len(x)} train step, {label}: {split['step']:.3f} ms (forward + loss "
            f"{split['forward']:.3f}, backward {split['backward']:.3f}, optimizer "
            f"{split['optimizer']:.3f}) on {name}")
    return total


def sharded_stereo_slice(name: str) -> dict:
    """Phase 11, the stereo model: PSMNetCSPN at StereoConfig width with the
    cost volume's D (48) over an in-process mesh of S = 2, one b4 train step
    through make_stereo_train_step against the unsharded float32 and
    float64 steps (phase 5's rule); both timed.  Returns the kernels'
    launches on the sharded step."""
    from cspn_tpu_torch.models.stereo import PSMNetCSPN, smooth_l1_disparity_loss
    from cspn_tpu_torch.parallel import exchange_counts, halo, make_mesh
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.train.stereo_loop import StereoConfig, build_stereo_model, make_stereo_train_step
    from cspn_tpu_torch.utils.profiling import stereo_batch, train_step_split_ms

    cfg = StereoConfig()
    mesh = make_mesh(spatial=2)

    def optimizer(m):
        return make_optimizer(m.parameters(), cfg.lr, momentum=0.9, weight_decay=1e-4,
                              nesterov=False)

    plain = build_stereo_model(cfg, train=True, device="cuda", seed=0)
    plain.cspn_gate_dtype = torch.float32  # the sharded segments' gates
    with torch.device("cuda"):
        sharded = PSMNetCSPN(max_disp=cfg.max_disp, features=cfg.features,
                             cspn_steps=cfg.cspn_steps, spatial_mesh=mesh)
    oracle = plain_stereo_twin(cfg, train=True, gate_dtype=torch.float32).to(torch.float64)
    models = {"kernel": sharded, "plain": plain, "float64": oracle}
    for m in (sharded, oracle):
        m.load_state_dict(plain.state_dict())
        m.train()
    left, right, disp = stereo_batch(cfg, cfg.batch_size, seed=0)
    d = cfg.max_disp // 4
    (_, d_ext, *plane), k = stereo_segment()  # the K phase 3 checked the 3D kernels at
    if (d_ext - 2 * k, *plane) != (d // 2, left.shape[1] // 4, left.shape[2] // 4):
        raise AssertionError(f"STEREO_SHAPE {STEREO_SHAPE} is not this model's volume")
    rounds = -(-STEPS // k)
    results = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, m in models.items():
            dt = next(m.parameters()).dtype
            step = make_stereo_train_step(m, optimizer(m), cfg.max_disp)
            torch.cuda.synchronize()
            reset_launches()
            loss, _ = step(left.to(dt), right.to(dt), disp.to(dt))
            torch.cuda.synchronize()
            if label == "kernel":
                launches, pairs = read_launches(), halo.exchanges
                want = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn3d_fwd=rounds, cspn3d_bwd=rounds)
                want_pairs = exchange_counts.expected_ppermutes_nd(STEPS, k) // 2
                log(f"  sharded stereo train step b{cfg.batch_size} (D={d} over S=2, K={k}): "
                    f"launches {launches}, {pairs} exchanges (expected {want}, {want_pairs})")
                if launches != want or pairs != want_pairs:
                    raise AssertionError(f"sharded stereo step: launched {launches}, {pairs} "
                                         "exchanges")
            results[label] = (loss.item(), {n_: p.grad for n_, p in m.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = False
    check_against_oracle(results["kernel"], results["plain"], results["float64"])
    del models, results, oracle

    def loss_fn(out, dd):
        return smooth_l1_disparity_loss(out, dd, cfg.max_disp)

    for label in ("sharded", "unsharded", "unsharded", "sharded"):
        m = sharded if label == "sharded" else plain
        split = train_step_split_ms(m, optimizer(m), loss_fn, (left, right), disp)
        log(f"  stereo b{cfg.batch_size} train step, {label}: {split['step']:.3f} ms (forward + "
            f"loss {split['forward']:.3f}, backward {split['backward']:.3f}, optimizer "
            f"{split['optimizer']:.3f}) on {name}")
    return launches


def demo_slice(name: str, dim: int) -> dict:
    """Phase 10: `python -m cspn_tpu_torch demo --dim-num {dim}` (batch 3, 24
    steps) for DEMO_ITERS iterations; returns each kernel's launches during
    the demo.  Its first loss is held against the same draws through the
    plain cspn_nd on the card."""
    from cspn_tpu_torch import cli
    from cspn_tpu_torch.ops.cspn import cspn_nd

    args = cli.build_parser().parse_args(["demo", "--dim-num", str(dim), "--iter-num",
                                          str(DEMO_ITERS)])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = args.fn(args)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()
    kernels = {"paddle2d": DEMO_ITERS} if dim == 2 else {"cspn3d_fwd": DEMO_ITERS,
                                                         "cspn3d_bwd": DEMO_ITERS}
    expected = dict(dict.fromkeys(KERNEL_NAMES, 0), **kernels)
    log(f"  demo --dim-num {dim}: {DEMO_ITERS} Adam iterations in {elapsed:.3f} s on {name}, "
        f"losses {[round(v, 6) for v in losses]}; launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"demo --dim-num {dim} launched {launches}, expected {expected}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"demo --dim-num {dim}: losses {losses} not finite and falling")
    map_shape = (48, 64, 128)[3 - dim:]
    rng = np.random.default_rng(0)  # the demo's draws
    guide = torch.tensor(rng.random((args.batch_size, *map_shape, 3**dim - 1)), dtype=torch.float32,
                         device="cuda")
    feat = torch.tensor(rng.random((args.batch_size, *map_shape, 1)), dtype=torch.float32,
                        device="cuda")
    with torch.no_grad():  # the 3D kernels' bf16 gate rounding on the plain route
        plain = cspn_nd(guide, feat, steps=args.prop_step, backend="reference",
                        gate_dtype=torch.bfloat16 if dim == 3 else None).mean().item()
    rel = abs(losses[0] - plain) / abs(plain)
    log(f"  first loss {losses[0]:.7f} vs the plain cspn_nd's {plain:.7f} (rel {rel:.2e}, tol "
        f"{LOSS_RTOL:g})")
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"demo --dim-num {dim}: first loss off the plain version by {rel:.2e}")
    return launches


def probe_slice(name: str) -> dict:
    """The probe path: `python -m cspn_tpu_torch.utils.step_probe`'s
    measurement (two-point slope, every dtype pair, one block per SM);
    returns its launches and prints its results."""
    from cspn_tpu_torch.utils import step_probe

    torch.cuda.synchronize()
    reset_launches()
    results = step_probe.run_probe(trials=PROBE_TRIALS)
    launches = read_launches()
    for r in results:
        log(f"  step_probe {r['gate_dtype']}/{r['state_dtype']} on {r['blocks']} blocks of [8,512]: "
            f"{r['ns_per_iter']:.3f} ns per iteration, {r['ps_per_px_iter']:.5f} ps per "
            f"px-iteration, {r['Tops_per_s']:.3f} Tops/s (19 ops per px) on {name}")
    # each pair: one warm-up launch at each of the two points, then a
    # launch at each point per trial
    expected = dict(dict.fromkeys(KERNEL_NAMES, 0),
                    step_probe=len(step_probe.PAIRS) * 2 * (PROBE_TRIALS + 1))
    if launches != expected:
        raise AssertionError(f"the probe path launched {launches}, expected {expected}")
    return launches


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


@contextlib.contextmanager
def decoder_d2s(fn):
    """The depth-to-space of the decoders (models/decoder.py and the int8
    subpixel convs, utils/quant.py) replaced by `fn` within the block."""
    from cspn_tpu_torch.models import decoder
    from cspn_tpu_torch.utils import quant

    saved = decoder.depth_to_space2, quant.depth_to_space2
    decoder.depth_to_space2 = quant.depth_to_space2 = fn
    try:
        yield
    finally:
        decoder.depth_to_space2, quant.depth_to_space2 = saved


def check_d2s_on_path(label: str, model, x, gen) -> set:
    """Phase 13: each depth-to-space call of `model`'s forward on `x` run by
    the `d2s` kernel and its adjoint by the `s2d` kernel (under a random
    cotangent), both held bit for bit against the plain versions on the
    forward's own activations, in the form the decoder hands them over (one
    tensor, or four phases); returns the (joined input shape, crop, dtype,
    form) cases."""
    from cspn_tpu_torch.ops import d2s

    cases = set()

    def checked(t, oh, ow):
        phases = not isinstance(t, torch.Tensor)
        first = t[0] if phases else t
        h, w = first.shape[2:]
        y = d2s._launch([p.contiguous() for p in t] if phases else t.contiguous(), oh, ow)
        ct = torch.randn(y.shape, device="cuda", generator=gen).to(first.dtype)
        back = d2s._launch_bwd(ct, h, w, phases=phases)
        want = d2s.space_to_depth2_ref(ct, h, w)
        if not (torch.equal(y, d2s.depth_to_space2_ref(t, oh, ow))
                and torch.equal(torch.cat(back, 1) if phases else back, want)):
            raise AssertionError(f"{label}: d2s / s2d at {tuple(want.shape)} -> ({oh},{ow}) "
                                 f"{first.dtype} differ from the plain versions")
        cases.add((tuple(want.shape), (oh, ow), str(first.dtype).removeprefix("torch."),
                   "four phases" if phases else "one tensor"))
        return y

    with decoder_d2s(checked), torch.inference_mode():
        model(x)
    return cases


def plain_twin(model):
    """A copy of a served model on the plain 2D CSPN (its bf16 or int8
    convs, weight cache and activation scales kept)."""
    twin = copy.deepcopy(model)
    twin.cspn_backend = "reference"
    return twin


def precision_serve(name: str, label: str, cfg, buckets, int8_from: int, requests,
                    calib_batch: int) -> dict:
    """Phase 13, serving: `cfg`'s model (seeded random weights, BN
    statistics calibrated on a synthetic batch, saved as best_model) served
    through load_server on both paths, with dynamic and then with static
    activation scales: each bucket's warmup with its peak memory, the
    requests' launches and per-path counters, frames/s per bucket (host
    clock) and its forward (events), and the outputs' rel-norms, bf16
    against float32 and int8 against bf16.  Each request's output is held
    to a plain twin's (the same models on the plain 2D CSPN and the plain
    depth-to-space, served through a DepthServer of their own), and each
    bucket's depth-to-space calls to the plain versions bit for bit
    (check_d2s_on_path).  Returns the kernels' launches on the served
    requests."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.ops import d2s
    from cspn_tpu_torch.serving import (WARMUP_FORWARDS, DepthServer, chunk_plan, load_server,
                                        pick_bucket)
    from cspn_tpu_torch.utils.profiling import calibrated_model

    h, w = cfg.data.crop_hw
    model32 = calibrated_model(cfg, calib_batch=calib_batch)
    ds = SyntheticDepthDataset(length=max(*buckets, *requests), hw=(h, w),
                               n_sample=cfg.data.n_sample, seed=1, split="val")
    frames = np.stack([ds[i]["rgbd"] for i in range(len(ds))])
    chunks = [s_ for n in requests for s_ in chunk_plan(n, buckets)]
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as ckpt_dir:
        torch.save(model32.state_dict(), os.path.join(ckpt_dir, "best_model.pt"))
        cfg = dataclasses.replace(cfg, best_model_dir=ckpt_dir)
        for static in (False, True):
            t0 = time.perf_counter()
            srv = load_server(cfg, buckets=buckets, device="cuda", int8_from=int8_from,
                              act_static=static)
            scales = "static activation scales" if static else "dynamic activation scales"
            log(f"  {label}, {scales}: load_server(buckets {buckets}, int8_from {int8_from}) in "
                f"{time.perf_counter() - t0:.1f} s (bf16 cast, int8 weight cache"
                f"{', calibration on 8 val frames' if static else ''})")
            for b in buckets:  # the warmup, a bucket at a time, with its peak
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                srv._run_bucket(torch.zeros((b, h, w, 4), device="cuda"), b)
                torch.cuda.synchronize()
                log(f"    warmup bucket {b} ({srv.path_for(b)}): {WARMUP_FORWARDS} eager forwards "
                    f"and the graph's capture in {time.perf_counter() - t0:.1f} s, peak device "
                    f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (cuDNN's "
                    "algorithm timing included) on " + name)
            log(f"    {len(srv.graphs)} graphs captured: {graph_memory(srv)}")
            for k in srv.served:
                srv.served[k] = 0
            torch.cuda.synchronize()
            reset_launches()
            outs = [srv.predict(frames[:n]) for n in requests]
            got = read_launches()
            forwards = len(chunks)
            expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_tiled=forwards,
                            d2s=d2s_per_forward(srv.models["bf16"]) * forwards)
            want_served = {p_: sum(c for c in chunks if srv.path_for(pick_bucket(c, buckets)) == p_)
                           for p_ in ("bf16", "int8")}
            log(f"    requests {requests}: launches {got} (expected {expected}); served "
                f"{srv.served} (expected {want_served})")
            if got != expected or srv.served != want_served or not want_served["int8"] \
                    or not want_served["bf16"]:
                raise AssertionError(f"{label} served run: launches {got}, served {srv.served}")
            for k, v in got.items():
                launches[k] += v
            for n, out in zip(requests, outs):
                if out.shape != (n, h, w) or not np.isfinite(out).all():
                    raise AssertionError(f"{label}: bad output {out.shape}")
            twin = DepthServer(plain_twin(srv.models["bf16"]), buckets,
                               plain_twin(srv.models["int8"]), int8_from, cuda_graphs=False)
            torch.cuda.synchronize()
            reset_launches()
            with decoder_d2s(d2s.depth_to_space2_ref):
                wants = [twin.predict(frames[:n]) for n in requests]
            torch.cuda.synchronize()
            if any(read_launches().values()) or twin.served != want_served:
                raise AssertionError(f"{label} plain twin: launches {read_launches()}, served "
                                     f"{twin.served}")
            worst = 0.0
            for n, out, want in zip(requests, outs, wants):
                err, scale = float(np.abs(out - want).max()), float(np.abs(want).max())
                path = srv.path_for(pick_bucket(min(n, buckets[-1]), buckets))
                if not err <= PRECISION_TWIN_TOL * scale:
                    raise AssertionError(f"{label} request {n} ({path}): served output vs plain "
                                         f"twin {err:.3e} > {PRECISION_TWIN_TOL * scale:.3e}")
                worst = max(worst, err / scale)
            log(f"    served outputs vs the plain twin (plain 2D CSPN and depth-to-space, "
                f"requests {requests}): max|err| / max|plain| = {worst:.3e} (tol "
                f"{PRECISION_TWIN_TOL:.3e})")
            del twin, wants
            eager = DepthServer(srv.models["bf16"], buckets, srv.models["int8"], int8_from,
                                cuda_graphs=False)
            check_graphed(f"{label}, {scales}", srv, eager, [frames[:n] for n in requests],
                          frames, name)
            del eager
            if not static:  # each path at every bucket, graphed and eager
                for p_ in ("bf16", "int8"):
                    one = DepthServer(srv.models[p_], buckets)
                    one.warmup(h, w)
                    log(f"    the {p_} path at every bucket ({graph_memory(one)}):")
                    time_graphed(one, DepthServer(srv.models[p_], buckets, cuda_graphs=False),
                                 frames, name)
                    del one
            gen = torch.Generator(device="cuda").manual_seed(13)
            for b in buckets:
                cases = check_d2s_on_path(f"{label} bucket {b}", srv.models[srv.path_for(b)],
                                          torch.from_numpy(frames[:b]).cuda(), gen)
                log(f"    bucket {b} ({srv.path_for(b)}): d2s / s2d bit for bit at the "
                    f"forward's {len(cases)} shapes: " + ", ".join(
                        f"{list(sh)}->({oh},{ow}) {dt} ({form})"
                        for sh, (oh, ow), dt, form in sorted(cases)))
            with torch.inference_mode():
                fwd = {}
                for b in buckets:
                    path, req = srv.path_for(b), frames[:b]
                    window = max(PRECISION_WINDOW // b, 4)
                    t0 = time.perf_counter()
                    for _ in range(window):
                        srv.predict(req)
                    fps = b * window / (time.perf_counter() - t0)
                    x = torch.from_numpy(req).cuda()
                    # both paths' forwards at every bucket: the crossover
                    for p_ in ("bf16", "int8"):
                        fwd[p_, b] = time_ms(lambda: srv.models[p_](x), reps=5, warmup=1)
                    log(f"    bucket {b} ({path}): served {fps:.2f} frames/s (host clock, "
                        f"{window} requests of {b}); forward (events) bf16 {fwd['bf16', b]:.3f} "
                        f"ms = {b * 1e3 / fwd['bf16', b]:.2f} frames/s, int8 "
                        f"{fwd['int8', b]:.3f} ms = {b * 1e3 / fwd['int8', b]:.2f} frames/s on "
                        f"{name}")
                wins = [b for b in buckets if fwd["int8", b] < fwd["bf16", b]]
                log(f"    int8 forward faster than bf16 at buckets {wins} of {buckets} (the "
                    f"server routes int8 from {int8_from})")
                b8 = min(b for b in buckets if srv.path_for(b) == "int8")
                x = torch.from_numpy(frames[:b8]).cuda()
                o32, o16, o8 = model32(x), srv.models["bf16"](x), srv.models["int8"](x)
            rel16, rel8 = _rel(o16, o32), _rel(o8, o16)
            log(f"    b{b8} outputs: rel-norm bf16 vs float32 {rel16:.4e}, int8 vs bf16 {rel8:.4e} "
                "(random weights; JAX bounds int8 at 0.08 of float, tests/test_quant.py)")
            if not (np.isfinite(rel16) and np.isfinite(rel8)):
                raise AssertionError(f"{label}: non-finite outputs")
            del srv, o32, o16, o8
    return launches


def _bf16_step_models(build, cfg32, cfg16):
    """(float32 kernel, bf16 kernel, bf16 plain CSPN, float64 oracle)
    models from `build(cfg, backend)`, the float32 kernel model's weights in
    all four."""
    m32 = build(cfg32, "auto")
    models = {"float32": m32, "bf16 kernel": build(cfg16, "auto"),
              "bf16 plain": build(cfg16, "reference"),
              "float64": build(cfg32, "reference").to(torch.float64)}
    for m in models.values():
        if m is not m32:
            m.load_state_dict(m32.state_dict())
    return models


def _bf16_step(name: str, label: str, models, step_fn, inputs, target, want_launches):
    """One train step of each model from the same weights on the same batch
    (deterministic cuDNN): the bf16 kernel step's launches, the bf16 kernel
    step held to the bf16 plain-CSPN step and the float64 oracle by phase
    5's rule, both float32 and bf16 distances from the oracle printed; then
    the float32 and bf16 steps timed in turns."""
    results = {}
    torch.backends.cudnn.deterministic = True
    try:
        for k, m in models.items():
            dt = next(m.parameters()).dtype
            torch.cuda.synchronize()
            reset_launches()
            loss = step_fn(m)(*(t.to(dt) for t in inputs), target.to(dt))[0]
            torch.cuda.synchronize()
            if k == "bf16 kernel":
                launches = read_launches()
                if launches != want_launches:
                    raise AssertionError(f"{label} bf16 step launched {launches}, expected "
                                         f"{want_launches}")
            results[k] = (loss.item(), {n_: p.grad for n_, p in m.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = False
    loss64, g64 = results["float64"]
    for k in ("float32", "bf16 kernel"):
        loss, grads = results[k]
        if not np.isfinite(loss):
            raise AssertionError(f"{label} {k} step: loss {loss}")
        flat = torch.cat([grads[n_].double().flatten() for n_ in g64])
        flat64 = torch.cat([g.flatten() for g in g64.values()])
        log(f"  {label} {k} step: loss {loss:.6f} (float64 oracle {loss64:.6f}, rel "
            f"{abs(loss - loss64) / abs(loss64):.3e}); gradients' rel-norm from the oracle "
            f"{_rel(flat, flat64):.4e}")
    check_against_oracle(results["bf16 kernel"], results["bf16 plain"], results["float64"],
                         labels=("bf16 kernel", "bf16 plain CSPN"))
    times = {"float32": [], "bf16 kernel": []}
    for k in ("float32", "bf16 kernel", "bf16 kernel", "float32"):
        m = models[k]
        torch.cuda.reset_peak_memory_stats()
        split = train_step_split(m, step_fn, inputs, target)
        times[k].append((split, torch.cuda.max_memory_allocated() / 2**30))
    n = target.shape[0]
    for k, runs in times.items():
        log(f"  {label} train step b{n}, {k}: " + " / ".join(
            f"{sp['step']:.3f} ms (forward {sp['forward']:.3f}, backward {sp['backward']:.3f}, "
            f"optimizer {sp['optimizer']:.3f}; peak {gib:.2f} GiB)" for sp, gib in runs)
            + f" on {name}")
    return launches


def train_step_split(model, step_fn, inputs, target) -> dict:
    """utils/profiling.train_step_split_ms of `model` with the optimizer
    and loss `step_fn` builds for it."""
    from cspn_tpu_torch.utils.profiling import train_step_split_ms

    step = step_fn(model)
    return train_step_split_ms(model, step.optimizer, step.loss_fn, inputs, target)


def precision_train(name: str) -> dict:
    """Phase 13, training: one bf16 nyu_train b8 step (the 2D CSPN float32,
    the d2s / s2d kernels at bf16) and one bf16 stereo b4 step (the 3D
    kernels on bf16 gates), each from the float32 model's weights, beside
    the float32 step (_bf16_step).  The plain-CSPN stereo twin and the
    float64 oracle round the gates to bf16 as the kernels do.  Returns the
    kernels' launches on the two bf16 kernel steps."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.models.stereo import smooth_l1_disparity_loss
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.loss import LOSSES
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.train.stereo_loop import StereoConfig, build_stereo_model
    from cspn_tpu_torch.utils.profiling import stereo_batch

    def stepper(loss_fn, nesterov):
        def step_fn(model):
            opt = make_optimizer(model.parameters(), 0.01, momentum=0.9, weight_decay=1e-4,
                                 nesterov=nesterov)

            def step(*args):
                *inputs, target = args
                model.train()
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model(*inputs), target)
                loss.backward()
                opt.step()
                return loss.detach(), None

            step.optimizer, step.loss_fn = opt, loss_fn
            return step
        return step_fn

    launches = dict.fromkeys(KERNEL_NAMES, 0)
    cfg32 = _train_cfg("")
    cfg16 = dataclasses.replace(cfg32, model=dataclasses.replace(cfg32.model, dtype="bfloat16"))

    def build_unet(cfg, backend):
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_backend=backend))
        return build_model(cfg, train=True, device="cuda", seed=0)

    models = _bf16_step_models(build_unet, cfg32, cfg16)
    ds = SyntheticDepthDataset(length=8, hw=tuple(cfg32.data.crop_hw), n_sample=cfg32.data.n_sample,
                               seed=1)
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(8)])).cuda()
    # ground truth 1 to 2 above or below the float32 prediction (train_slice's
    # rule): no L1 derivative flips its sign under rounding
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        pred = models["float32"](x)
    side = torch.where(torch.rand(pred.shape, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
    depth = pred + side * (1.0 + torch.rand(pred.shape, device="cuda", generator=gen))
    per = d2s_per_forward(models["bf16 kernel"])
    got = _bf16_step(name, "nyu_train", models, stepper(LOSSES["l1"], True), (x,), depth,
                     dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=1, cspn2d_bwd=1, d2s=per,
                          s2d=per))
    for k, v in got.items():
        launches[k] += v
    del models

    scfg32 = StereoConfig()
    scfg16 = dataclasses.replace(scfg32, dtype="bfloat16")

    def build_stereo(cfg, backend):
        if backend == "reference":  # the plain twin and the oracle: the kernels' gate rounding
            return plain_stereo_twin(cfg, train=True, seed=0)
        return build_stereo_model(cfg, train=True, device="cuda", seed=0)

    left, right, disp = stereo_batch(scfg32, scfg32.batch_size, seed=0)
    models = _bf16_step_models(build_stereo, scfg32, scfg16)
    models["float32"].cspn_gate_dtype = torch.float32  # the float32 step as the float32 paths run it

    def stereo_loss(out, d):
        return smooth_l1_disparity_loss(out, d, scfg32.max_disp)

    got = _bf16_step(name, "stereo", models, stepper(stereo_loss, False), (left, right), disp,
                     dict(dict.fromkeys(KERNEL_NAMES, 0), cspn3d_fwd=1, cspn3d_bwd=1))
    for k, v in got.items():
        launches[k] += v
    return launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ddp_slice(name: str) -> dict:
    """Phase 12: nyu_train's b8 step through DistributedDataParallel on a
    1-rank NCCL group in this process (parallel/data.py), on both routes
    (sync-BN with the float32 reduce; per-replica BN with the bf16 reduce),
    against the unwrapped step (train/loop.py:make_train_step) from the
    same weights on the same batch, with deterministic cuDNN.  The sync-BN
    route's gradients are held to the float64 oracle by phase 5's rule
    (within ORACLE_FACTOR x the unwrapped step's distance, trap 5); the bf16
    route's to the unwrapped step's within half a bf16 ulp (2^-8 of each
    value: one rank reduces bf16(g) / 1).  The reduce hook's bytes: float32
    4 x the parameters a step, bf16 half of that.  Then the three steps
    timed in turns with their peak memory, and `bench-scaling --mode train`
    (its one point on one card).  Returns each kernel's launches during the
    two DDP steps compared."""
    import torch.distributed as dist

    from cspn_tpu_torch import cli
    from cspn_tpu_torch.parallel import make_mesh
    from cspn_tpu_torch.parallel.data import DataParallel
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.factory import build_loaders
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer

    cfg = _train_cfg("")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh(None, 1, dist.group.WORLD)
        frames = [build_loaders(cfg)[0].dataset[i] for i in range(cfg.data.batch_size_train)]
        x = torch.from_numpy(np.stack([f["rgbd"] for f in frames])).cuda()
        models, steps, dps = {}, {}, {}
        for label in ("unwrapped", "sync", "bf16", "float64"):
            model = build_model(cfg, train=True, device="cuda", seed=0)
            if label == "float64":
                model = model.double()
                model.cspn_backend = "reference"
            models[label] = model
            if label in ("sync", "bf16"):
                dps[label] = DataParallel(model, mesh, None if label == "sync" else "bfloat16")
            steps[label] = make_train_step(model, make_optimizer(model.parameters()),
                                           data_parallel=dps.get(label))
        n_params = sum(p.numel() for p in models["unwrapped"].parameters())
        # ground truth 1 to 2 above or below the prediction (no L1 sign flip under rounding)
        state = {k: v.clone() for k, v in models["unwrapped"].state_dict().items()}
        with torch.no_grad():
            pred = models["unwrapped"](x)
        models["unwrapped"].load_state_dict(state)
        gen = torch.Generator(device="cuda").manual_seed(2)
        side = torch.where(torch.rand(pred.shape, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
        depth = pred + side * (1.0 + torch.rand(pred.shape, device="cuda", generator=gen))
        results = {}
        torch.backends.cudnn.deterministic = True
        try:
            torch.cuda.synchronize()
            reset_launches()
            for label in ("sync", "bf16"):
                loss, _ = steps[label](x, depth)
                results[label] = (loss.item(), {k: p.grad.clone() for k, p in
                                                models[label].named_parameters()})
            torch.cuda.synchronize()
            launches = read_launches()
            for label in ("unwrapped", "float64"):
                dt = next(models[label].parameters()).dtype
                loss, _ = steps[label](x.to(dt), depth.to(dt))
                results[label] = (loss.item(), {k: p.grad for k, p in
                                                models[label].named_parameters()})
        finally:
            torch.backends.cudnn.deterministic = False
        per_fwd = d2s_per_forward(models["unwrapped"])
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=2, cspn2d_bwd=2,
                        d2s=2 * per_fwd, s2d=2 * per_fwd)
        log(f"  nyu_train b8 through DDP (1-rank NCCL group): launches {launches} over the two "
            f"routes' steps (expected {expected})")
        if launches != expected:
            raise AssertionError(f"the DDP steps launched {launches}, expected {expected}")
        check_against_oracle(results["sync"], results["unwrapped"], results["float64"],
                             ("DDP sync-BN", "unwrapped"))
        loss_b, grads_b = results["bf16"]
        loss_u, grads_u = results["unwrapped"]
        worst = max(((grads_b[k] - g).abs() / g.abs().clamp_min(1e-30)).max().item()
                    for k, g in grads_u.items() if g.abs().max() > 0)
        off = [k for k, g in grads_u.items() if not ((grads_b[k] - g).abs() <= 2.0 ** -8 * g.abs()).all()]
        loss_rel = abs(loss_b - loss_u) / abs(loss_u)
        log(f"  bf16 route against the unwrapped step: loss {loss_b:.6f} vs {loss_u:.6f} (rel "
            f"{loss_rel:.2e}), worst gradient element {worst:.3e} of its value (tol 2^-8 = "
            f"{2.0 ** -8:.3e}, half a bf16 ulp)")
        if off or not loss_rel <= LOSS_RTOL:
            raise AssertionError(f"bf16-route gradients off the unwrapped step's by more than "
                                 f"bf16 rounding: {off[:5]}, loss rel {loss_rel:.2e}")
        for label, want in (("sync", {"float32": 4 * n_params}),
                            ("bf16", {"float32": 4 * n_params, "bfloat16": 2 * n_params})):
            got = dict(dps[label].hook.bytes)
            log(f"  {label} route: the reduce hook's bytes for one step {got} ({n_params} "
                "parameters)")
            if got != want:
                raise AssertionError(f"{label} route reduced {got}, expected {want}")
        del results, grads_b, grads_u, models["float64"]

        times = {label: [] for label in ("unwrapped", "sync", "bf16")}
        peaks = {}
        for label in ("unwrapped", "sync", "bf16", "bf16", "sync", "unwrapped"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times[label].append(time_ms(functools.partial(steps[label], x, depth), reps=5,
                                        warmup=1))
            peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        for label, ts in times.items():
            log(f"  train step {label} (batch 8, median of 5, CUDA events, in turns U S B B S U): "
                f"{ts[0]:.3f} / {ts[1]:.3f} ms; peak device memory {peaks[label]:.2f} GiB on {name}")
        del models, steps, dps
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    args = cli.build_parser().parse_args(["bench-scaling", "--mode", "train"])
    records = args.fn(args)
    log(f"  bench-scaling --mode train: {records} ({time.perf_counter() - t0:.1f} s, the spawned "
        "rank included)")
    if not (len(records) == 1 and records[0]["devices"] == 1 and records[0]["frames_per_s"] > 0
            and records[0]["device"] == name):
        raise AssertionError(f"bench-scaling on one card gave {records}")
    return launches


# phase 14: the exported dtypes (int8 with static activation scales), the
# request sizes each artifact serves, and the frames of the CLI's eval and infer
DEPLOY_DTYPES = ("float32", "bfloat16", "int8")
DEPLOY_REQUESTS = (1, 3, 8)
DEPLOY_FRAMES = 4
# the fresh process that reloads the artifacts (argv: directory, dtypes):
# it imports export.py and the op modules, never cspn_tpu_torch.models.  It
# serves with cuDNN off, PyTorch's own convolutions, as the eager outputs it
# is held to were computed: cuDNN picks its algorithms by timing in each
# process (and its plan cache keeps this process's picks when the timing is
# off), and two algorithms round a bf16 convolution apart, which grows
# through the random-weight network (ROADMAP trap 14; 8.6-10.7% of the
# output's max on an NVIDIA H100 80GB HBM3 at 700 W)
_SERVE_ARTIFACTS = """
import sys, torch
from cspn_tpu_torch import export
from cspn_tpu_torch.ops import cspn_cuda, d2s
folder, dtypes = sys.argv[1], sys.argv[2:]
frames = [x.cuda() for x in torch.load(folder + "/frames.pt")]
served = {}
for dtype in dtypes:
    art = export.load_artifact(folder + "/" + dtype + ".pt2")
    torch.backends.cudnn.enabled = False
    art.call(frames[0])
    torch.cuda.synchronize()
    cspn_cuda.tiled_launches = d2s.launches = d2s.bwd_launches = 0
    cspn_cuda.launches = cspn_cuda.bwd_launches = 0
    outs = [art.call(x).cpu() for x in frames]
    served[dtype] = {"outputs": outs, "launches": {
        "cspn2d_tiled": cspn_cuda.tiled_launches, "d2s": d2s.launches, "s2d": d2s.bwd_launches,
        "cspn2d_fwd": cspn_cuda.launches, "cspn2d_bwd": cspn_cuda.bwd_launches}}
served["models_imported"] = "cspn_tpu_torch.models" in sys.modules
torch.save(served, folder + "/served.pt")
"""


def _reference_checkpoint(model, path: str) -> None:
    """`model`'s weights as the reference's training saves them
    (torch.save of a DataParallel state dict, reference train.py:277-280):
    `module.` prefixes, BN counters, and modules the reference builds but
    its forward never calls."""
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    sd.update({"module.post_process_layer.sum_conv.weight": torch.ones(1, 8, 3, 3),
               "module.up_proj_layer1.conv1.weight": torch.zeros(2, 2, 5, 5),
               "module.bn1.num_batches_tracked": torch.tensor(7)})
    torch.save(sd, path)


def _held(label: str, got, want, tol: float) -> float:
    """max|got - want| / max|want|, raising above `tol` (0: bit for bit)."""
    err, scale = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
    if not (torch.equal(got, want) if tol == 0 else err <= tol * scale):
        raise AssertionError(f"{label}: max|err| {err:.3e} > {tol:g} x max|want| {scale:.3e}")
    return err / max(scale, 1e-30)


def deployment_slice(name: str) -> dict:
    """Phase 14 (module docstring).  Returns the kernels' launches on the
    exported programs' served requests in this process."""
    from cspn_tpu_torch import cli, export
    from cspn_tpu_torch.train.evaluate import load_eval_state
    from cspn_tpu_torch.utils.images import read_png
    from cspn_tpu_torch.utils.profiling import calibrated_model, nyu_eval_synthetic

    cfg = nyu_eval_synthetic()
    h, w = cfg.data.crop_hw
    model32 = calibrated_model(cfg)
    gen = torch.Generator().manual_seed(14)
    frames = [torch.randn((n, h, w, 4), generator=gen) for n in DEPLOY_REQUESTS]
    per_forward = {"cspn2d_tiled": 1, "d2s": d2s_per_forward(model32)}
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    eager, native, report = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as folder:
        pth = os.path.join(folder, "best_model.pth")
        _reference_checkpoint(model32, pth)
        torch.save(frames, os.path.join(folder, "frames.pt"))
        for dtype in DEPLOY_DTYPES:
            path = os.path.join(folder, f"{dtype}.pt2")
            t0 = time.perf_counter()
            if dtype == "float32":  # the subcommand, as a user runs it
                argv = ["export", "--preset", "nyu_eval", "--import-torch-checkpoint", pth,
                        "--height", str(h), "--width", str(w), "--out", path, "--check",
                        "--device", "cuda"]
                log("  python -m cspn_tpu_torch " + " ".join(argv))
                err = cli.cmd_export(cli.build_parser().parse_args(argv))
                model = load_eval_state(cfg, device="cuda", torch_checkpoint=pth)
                source = model32.state_dict()  # every tensor but the BN counters, which stay 0
                if not all(torch.equal(v, source[k]) for k, v in model.state_dict().items()
                           if not k.endswith("num_batches_tracked")):
                    raise AssertionError("the imported reference checkpoint differs from its model")
            else:
                mcfg = dataclasses.replace(cfg, model=dataclasses.replace(
                    cfg.model, dtype=dtype, act_static=dtype == "int8"))
                model = load_eval_state(mcfg, device="cuda", torch_checkpoint=pth)
                t1 = time.perf_counter()
                program = export.export_serving(model, h, w)
                t2 = time.perf_counter()
                export.save_artifact(program, path, {"arch": cfg.model.arch, "dtype": dtype,
                                                     "cspn_steps": cfg.model.cspn_steps,
                                                     "height": h, "width": w, "batch": None})
                log(f"  {dtype}{' (static scales)' if dtype == 'int8' else ''}: imported in "
                    f"{t1 - t0:.1f} s, exported in {t2 - t1:.1f} s, saved in "
                    f"{time.perf_counter() - t2:.1f} s")
            art = export.load_artifact(path)
            ops = export.op_counts(art.program)
            if ops != per_forward:
                raise AssertionError(f"{dtype} graph holds ops {ops}, expected {per_forward}")
            size = os.path.getsize(path)
            with torch.no_grad():
                eager[dtype] = [model(x.cuda()).cpu() for x in frames]
                torch.backends.cudnn.enabled = False  # as the fresh process serves
                native[dtype] = [model(x.cuda()).cpu() for x in frames]
                torch.backends.cudnn.enabled = True
            scale = max(e.abs().max().item() for e in eager[dtype])
            if dtype == "float32" and not err <= KERNEL_TOL * scale:
                raise AssertionError(f"export --check max|err| {err:.3e} > {KERNEL_TOL:g} x {scale:.3e}")
            torch.cuda.synchronize()
            reset_launches()
            outs = [art.call(x.cuda()).cpu() for x in frames]
            for k, n in read_launches().items():
                launches[k] += n
            tol = KERNEL_TOL if dtype == "float32" else PRECISION_TWIN_TOL
            worst = max(_held(f"{dtype} exported b{len(x)}", o, e, tol)
                        for x, o, e in zip(frames, outs, eager[dtype]))
            times = {"eager": [], "exported": []}
            with torch.no_grad():
                for b in (1, 8):
                    x = frames[-1][:b].cuda()
                    for form in ("eager", "exported", "exported", "eager"):
                        fn = model if form == "eager" else art.call
                        times[form].append((b, time_ms(lambda: fn(x), reps=5, warmup=1)))
            report[dtype] = {"bytes": size, "ops": ops, "max_rel_err": worst, "ms": times}
            log(f"  {dtype}: {size / 1e6:.1f} MB, graph ops {ops}, exported vs eager at b "
                f"{DEPLOY_REQUESTS}: max|err| / max|eager| {worst:.3e}; b1 / b8 forward ms, "
                "eager " + ", ".join(f"b{b} {t:.3f}" for b, t in times["eager"]) + "; exported "
                + ", ".join(f"b{b} {t:.3f}" for b, t in times["exported"]) + f" on {name}")
            del model, art
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0),
                        **{k: v * len(DEPLOY_REQUESTS) * len(DEPLOY_DTYPES)
                           for k, v in per_forward.items()})
        if launches != expected:
            raise AssertionError(f"exported programs launched {launches}, expected {expected}")
        log(f"  served b {DEPLOY_REQUESTS} on each artifact in this process: launches "
            f"{launches} (expected {expected})")

        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _SERVE_ARTIFACTS, folder, *DEPLOY_DTYPES],
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=ROOT))
        if proc.returncode != 0:
            raise AssertionError(f"the fresh process failed:\n{proc.stdout}\n{proc.stderr}")
        served = torch.load(os.path.join(folder, "served.pt"))
        if served.pop("models_imported"):
            raise AssertionError("loading and serving an artifact imported cspn_tpu_torch.models")
        for dtype, got in served.items():
            want = {k: v * len(DEPLOY_REQUESTS) for k, v in per_forward.items()}
            want.update(s2d=0, cspn2d_fwd=0, cspn2d_bwd=0)
            if got["launches"] != want:
                raise AssertionError(f"{dtype} in a fresh process launched {got['launches']}, "
                                     f"expected {want}")
            tol = KERNEL_TOL if dtype == "float32" else PRECISION_TWIN_TOL
            report[dtype]["fresh_max_rel_err"] = max(
                _held(f"{dtype} reloaded b{len(o)}", o, e, tol)
                for o, e in zip(got["outputs"], native[dtype]))
        log(f"  a fresh process (no cspn_tpu_torch.models; cuDNN off, for the eager outputs "
            f"too) reloaded and served all three in "
            f"{time.perf_counter() - t0:.1f} s: max|err| / max|eager| "
            + ", ".join(f"{d} {r['fresh_max_rel_err']:.3e}" for d, r in report.items())
            + ", launches exact")

        common = ["--preset", "nyu_eval", "--dataset", "synthetic", "--crop-hw", f"{h},{w}",
                  "--device", "cuda", "--best-model-dir", folder, "--import-torch-checkpoint", pth]
        t0 = time.perf_counter()
        cli.main(["eval", *common, "--runs", "1", "--max-batches", "1", "--batch-size-eval",
                  str(DEPLOY_FRAMES), "--dump-images"])
        dumped = sorted(os.listdir(os.path.join(folder, "eval_result")))
        want = sorted(f"{i:05d}_{t}.png" for i in range(DEPLOY_FRAMES)
                      for t in ("input", "gt", "pred"))
        if dumped != want:
            raise AssertionError(f"eval --dump-images wrote {dumped}, expected {want}")
        for f in dumped:
            img = read_png(os.path.join(folder, "eval_result", f))
            if img.shape != ((h, w, 3) if f.endswith("input.png") else (h, w)):
                raise AssertionError(f"{f}: shape {img.shape}")
        npy = os.path.join(folder, "preds.npy")
        cli.main(["infer", *common, "--buckets", "1,4", "--int8-from", "0", "--max-frames",
                  str(DEPLOY_FRAMES - 1), "--out", npy, "--out-dir",
                  os.path.join(folder, "infer_result")])
        preds = np.load(npy)
        for i, pred in enumerate(preds):
            img = read_png(os.path.join(folder, "infer_result", f"{i:05d}_pred.png"))
            if not np.array_equal(img, np.clip(pred * 25.5, 0, 255).astype(np.uint8)):
                raise AssertionError(f"infer --out-dir: {i:05d}_pred.png is not the prediction")
        log(f"  eval --import-torch-checkpoint --dump-images ({DEPLOY_FRAMES} frames) and infer "
            f"--out-dir ({len(preds)} frames) in {time.perf_counter() - t0:.1f} s: every PNG "
            "read back with zlib, the predictions' equal to the served ones")
    return launches


# phase 15 (files): NYU and KITTI frames as their datasets ship them -- 8-bit
# RGB and 16-bit depth PNGs (millimetres for NYU, metres x 256 for KITTI, with
# KITTI_VALID of the pixels valid) -- in (train, val) pairs, through
# two-column manifests
NYU_FILE_HW, NYU_FILES = (480, 640), (32, 8)
KITTI_FILE_HW, KITTI_FILES, KITTI_VALID = (375, 1242), (16, 4), 0.07
LOADER_WORKERS = 4
LOADER_REPEATS = 4  # the loaders' rates over the train split 4 times over: 16 batches an epoch
SPARSE_SIGMAS = 5  # a sample's sparse count within this many sigma of its Bernoulli mean
EVAL_RUNS = 5


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter `rows` [h, stride] uint8 with filter type y % 5 on row y
    (None, Sub, Up, Average, Paeth): h rows of a filter byte and the bytes."""
    h, stride = rows.shape
    r = rows.astype(np.int32)
    out = np.zeros((h, stride + 1), np.uint8)
    for y in range(h):
        a = np.concatenate([np.zeros(bpp, np.int32), r[y, :-bpp]])
        b = r[y - 1] if y else np.zeros(stride, np.int32)
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (0, a, b, (a + b) >> 1, paeth)[y % 5]
        out[y, 0] = y % 5
        out[y, 1:] = (r[y] - pred) & 0xFF
    return out


def check_png_unfilter() -> None:
    """The host library's png_unfilter against the plain numpy version on
    rows under all five filters, at 1, 2, 3, 4 and 6 bytes a pixel: bit for bit."""
    from cspn_tpu_torch.data import native
    from cspn_tpu_torch.utils.images import _unfilter_plain

    rng = np.random.default_rng(15)
    for bpp in (1, 2, 3, 4, 6):
        rows = rng.integers(0, 256, (25, 41 * bpp), dtype=np.uint8)
        rows[6:14] = rows[5]  # runs that Up and Paeth predict exactly
        raw = _filter_rows(rows, bpp).ravel()
        lib, plain = native.png_unfilter(raw, 25, 41 * bpp, bpp), _unfilter_plain(raw, 25, 41 * bpp, bpp)
        if not (np.array_equal(lib, plain) and np.array_equal(lib, rows)):
            raise AssertionError(f"png_unfilter at {bpp} bytes a pixel: library, plain version and "
                                 "the rows disagree")
    log("  png_unfilter (host library) equals its plain numpy version and the rows bit for bit under "
        "all five filters at 1, 2, 3, 4 and 6 bytes a pixel")


def write_file_frames(root: str) -> dict:
    """NYU and KITTI frames as PNG pairs (utils/images.py:write_png) made from
    the synthetic surfaces, seeded, and the script's two-column manifests;
    returns {(kind, split): manifest}, paths relative to `root`."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.utils.images import write_png

    manifests = {}
    for kind, hw, counts, seed in (("nyu", NYU_FILE_HW, NYU_FILES, 15),
                                   ("kitti", KITTI_FILE_HW, KITTI_FILES, 16)):
        ds = SyntheticDepthDataset(length=sum(counts), hw=hw, n_sample=1, seed=seed, split="val",
                                   return_raw_rgb=True)
        rng = np.random.default_rng(seed)
        for split, (lo, hi) in zip(("train", "val"), ((0, counts[0]), (counts[0], sum(counts)))):
            folder = os.path.join(root, kind, split)
            os.makedirs(folder)
            rows = []
            for i in range(lo, hi):
                frame = ds[i]
                rgb = np.clip(frame["raw_rgb"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
                if kind == "nyu":  # millimetres, the NYU toolbox's convention
                    depth = np.round(frame["depth"] * 1000.0).astype(np.uint16)
                else:  # metres x 256, the KITTI devkit's, KITTI_VALID of the pixels valid
                    depth = np.round(frame["depth"] * 8.0 * 256.0).astype(np.uint16)
                    depth[rng.random(hw) >= KITTI_VALID] = 0
                names = [os.path.join(kind, split, f"{i:05d}_{part}.png") for part in ("rgb", "depth")]
                write_png(os.path.join(root, names[0]), rgb)
                write_png(os.path.join(root, names[1]), depth)
                rows.append(",".join(names))
            path = os.path.join(root, f"{kind}_{split}.csv")
            with open(path, "w") as f:
                f.write("rgb,depth\n" + "\n".join(rows) + "\n")
            manifests[kind, split] = path
    return manifests


def _files_cfg(preset: str, manifests: dict, root: str, save_dir: str = "", **data):
    from cspn_tpu_torch.config import PRESETS

    cfg = PRESETS[preset]
    kind = "kitti" if preset.startswith("kitti") else "nyu"
    return dataclasses.replace(
        cfg, save_dir=save_dir, best_model_dir=save_dir, log_every=1,
        data=dataclasses.replace(cfg.data, input_format="img", root_dir=root,
                                 train_list=manifests[kind, "train"],
                                 eval_list=manifests[kind, "val"], **data))


class LoaderWaits:
    """A loader that records, on the host clock, how long each batch was
    waited for and each step's time (from a batch's delivery to the next
    request: the trainer's step, synchronized by its logging each step)."""

    def __init__(self, loader):
        self.loader, self.waits, self.steps = loader, [], []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it, last = iter(self.loader), None
        while True:
            t0 = time.perf_counter()
            if last is not None:
                self.steps.append(t0 - last)
            try:
                batch = next(it)
            except StopIteration:
                return
            last = time.perf_counter()
            self.waits.append(last - t0)
            yield batch

    def summary(self) -> str:
        w, s = [1e3 * v for v in self.waits], [1e3 * v for v in self.steps]
        return (f"waited {', '.join(f'{v:.1f}' for v in w)} ms for the batches, steps "
                f"{', '.join(f'{v:.1f}' for v in s)} ms (host clock; the first step includes "
                f"cuDNN's algorithm timing); after the first batch: wait median "
                f"{statistics.median(w[1:]) if len(w) > 1 else float('nan'):.2f} ms against step "
                f"median {statistics.median(s[1:]) if len(s) > 1 else float('nan'):.2f} ms")


def check_samples(label: str, ds, indices, hw) -> None:
    """Shapes, channel 3 equal to depth where it is nonzero, and the sparse
    count within SPARSE_SIGMAS sigma of its Bernoulli mean (p = n_sample /
    the pixels, or / the valid ones after depth /= s for KITTI)."""
    from cspn_tpu_torch.data import native

    worst = 0.0
    for i in indices:
        s = ds[i]
        rgbd, depth = s["rgbd"], s["depth"]
        if rgbd.shape != (*hw, 4) or depth.shape != hw or not np.isfinite(rgbd).all():
            raise AssertionError(f"{label}[{i}]: shapes {rgbd.shape} {depth.shape} or not finite")
        nz = rgbd[..., 3] != 0
        if not np.array_equal(rgbd[..., 3][nz], depth[nz]):
            raise AssertionError(f"{label}[{i}]: channel 3 differs from depth where it is nonzero")
        denom = depth.size if ds.sparse_denom == "total" else max(native.count_valid(depth), 1)
        p = min(ds.n_sample / denom, 1.0)
        n = int((depth != 0).sum())
        mean, sigma = n * p, np.sqrt(n * p * (1 - p))
        z = abs(int(nz.sum()) - mean) / max(sigma, 1e-30)
        if z > SPARSE_SIGMAS:
            raise AssertionError(f"{label}[{i}]: {int(nz.sum())} sparse samples, Bernoulli mean "
                                 f"{mean:.1f} sigma {sigma:.1f}")
        worst = max(worst, z)
    log(f"  {label}: {len(indices)} samples {hw[0]}x{hw[1]}, channel 3 equal to depth where it is "
        f"nonzero, sparse counts within {worst:.2f} sigma of their Bernoulli means (limit "
        f"{SPARSE_SIGMAS})")


def time_data_layer(label: str, ds, n: int = 8) -> None:
    """Decode ms (load_img_pair) and aug_pack ms a frame, one thread, over
    `n` samples of `ds` built through its own route."""
    from cspn_tpu_torch.data import datasets, native

    times = {"decode": [], "aug_pack": []}
    originals = {"decode": datasets.load_img_pair, "aug_pack": native.aug_pack}

    def timed(what):
        def fn(*args, **kwargs):
            t0 = time.perf_counter()
            out = originals[what](*args, **kwargs)
            times[what].append(1e3 * (time.perf_counter() - t0))
            return out
        return fn

    datasets.load_img_pair, native.aug_pack = timed("decode"), timed("aug_pack")
    try:
        t0 = time.perf_counter()
        for i in range(n):
            ds[i]
        total = 1e3 * (time.perf_counter() - t0) / n
    finally:
        datasets.load_img_pair, native.aug_pack = originals["decode"], originals["aug_pack"]
    log(f"  {label} data layer, one thread: decode (PNG pair) {statistics.median(times['decode']):.2f} "
        f"ms, aug_pack {statistics.median(times['aug_pack']):.2f} ms, the whole sample "
        f"{total:.2f} ms a frame (medians over {n} frames, host clock)")


def drain(loader, epochs: int, after_epoch) -> tuple[list, list, float]:
    """Iterate `loader` alone, calling `after_epoch()` after each epoch:
    (the first epoch's batches, each epoch's seconds to its first batch,
    the ms a batch after the first of each epoch)."""
    firsts, steady, n_steady, batches = [], 0.0, 0, None
    for e in range(epochs):
        t0 = time.perf_counter()
        stamps, got = [], []
        for b in loader:
            stamps.append(time.perf_counter())
            got.append(b)
        after_epoch()
        if e == 0:
            batches = got
        firsts.append(stamps[0] - t0)
        steady += stamps[-1] - stamps[0]
        n_steady += len(stamps) - 1
    return batches, firsts, 1e3 * steady / max(n_steady, 1)


class Repeated:
    """A dataset `times` over: loader epochs long enough for the workers to
    reach their steady rate (picklable for worker processes)."""

    def __init__(self, dataset, times: int):
        self.dataset, self.times = dataset, times

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def loader_rates(label: str, cfg) -> None:
    """The loader's host ms a batch, drained alone (no step consuming it),
    at one thread, LOADER_WORKERS threads and LOADER_WORKERS spawned
    processes, on a seeded train split LOADER_REPEATS over; the thread and
    process loaders' batches over one epoch bit for bit equal; the process
    loader drained over 2 epochs by one pool of workers (the same PIDs),
    the second epoch's first batch timed beside the first's."""
    from cspn_tpu_torch.data import DataLoader
    from cspn_tpu_torch.train.factory import build_dataset

    ds = Repeated(build_dataset(cfg, "train", seed=0), LOADER_REPEATS)
    bs = cfg.data.batch_size_train
    out = {}
    for mode, workers, epochs in (("thread", 1, 1), ("thread", LOADER_WORKERS, 1),
                                  ("process", LOADER_WORKERS, 2)):
        loader = DataLoader(ds, bs, shuffle=True, drop_last=True, num_workers=workers,
                            worker_mode=mode)
        pids = []  # the process loader's worker PIDs after each epoch
        try:
            out[mode, workers] = drain(loader, epochs,
                                       lambda loader=loader: pids.append(loader.worker_pids()))
        finally:
            loader.close()
        batches, firsts, ms = out[mode, workers]
        log(f"  {label} b{bs} loader, {workers} {mode} worker(s): {ms:.1f} ms a batch after the "
            f"first ({ms / bs:.2f} ms a frame), first batch after "
            f"{' / '.join(f'{t:.2f}' for t in firsts)} s in epoch{'s' if epochs > 1 else ''} "
            f"{' / '.join(str(e + 1) for e in range(epochs))} (host clock)")
        if mode == "process":
            if len(pids) != epochs or len(pids[0]) != workers or any(p != pids[0] for p in pids):
                raise AssertionError(f"{label}: the process loader's worker PIDs by epoch {pids}: "
                                     "one pool should serve every epoch")
            log(f"  {label}: the same {workers} worker processes (PIDs {pids[0]}) served both "
                "epochs; the pool closed after")
    a, b = out["thread", LOADER_WORKERS][0], out["process", LOADER_WORKERS][0]
    if len(a) != len(b) or any(not np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x):
        raise AssertionError(f"{label}: thread and process workers gave different batches")
    log(f"  {label}: thread and process workers gave the same {len(a)} batches bit for bit")


def files_slice(name: str) -> dict:
    """Phase 15 (module docstring).  Returns {path: launches} for the runs
    fed from files: files_train (nyu_train's fit), files_eval (nyu_eval's
    run_eval), files_kitti (kitti_benchmark's fit), files_mono (a nyu_mono
    step)."""
    from cspn_tpu_torch import cli
    from cspn_tpu_torch.data.datasets import read_manifest
    from cspn_tpu_torch.train.evaluate import run_eval
    from cspn_tpu_torch.train.factory import build_dataset, build_loaders
    from cspn_tpu_torch.train.loop import Trainer

    def loaded():
        return sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "h5py"))

    before = loaded()
    installed = [m for m in ("PIL", "h5py") if importlib.util.find_spec(m) is not None]
    log(f"  installed here: {installed or 'neither PIL nor h5py'}; imported before this phase: "
        f"{before or 'neither'}")
    check_png_unfilter()
    by_path = {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as root:
        t0 = time.perf_counter()
        manifests = write_file_frames(root)
        listed = os.path.join(root, "listed.csv")
        cli.main(["make-manifest", os.path.join(root, "nyu", "train"), listed, "--pattern",
                  "*_rgb.png", "--relative-to", root])
        if read_manifest(listed) != read_manifest(manifests["nyu", "train"]):
            raise AssertionError("make-manifest listed other RGB files than the script's manifest")
        log(f"  wrote {sum(NYU_FILES)} NYU pairs at {NYU_FILE_HW[0]}x{NYU_FILE_HW[1]} and "
            f"{sum(KITTI_FILES)} KITTI pairs at {KITTI_FILE_HW[0]}x{KITTI_FILE_HW[1]} (8-bit RGB, "
            f"16-bit depth PNGs) and their manifests in {time.perf_counter() - t0:.1f} s; "
            "make-manifest lists the script's NYU train RGB files")

        # the datasets themselves
        nyu, kitti = (_files_cfg("nyu_train", manifests, root),
                      _files_cfg("kitti_benchmark", manifests, root))
        for label, cfg in (("nyu_train", nyu), ("kitti_benchmark", kitti)):
            hw = tuple(cfg.data.crop_hw or (228, 304))
            for split in ("train", "val"):
                ds = build_dataset(cfg, split, seed=0)
                check_samples(f"{label} {split}", ds, range(min(len(ds), 8)), hw)
            a, b = build_dataset(cfg, "val", seed=0), build_dataset(cfg, "val", seed=0)
            if any(not np.array_equal(a[i][k], b[i][k]) for i in range(len(a)) for k in a[i]):
                raise AssertionError(f"{label}: two val datasets of one seed differ")
            log(f"  {label}: two val datasets of seed 0 equal bit for bit ({len(a)} frames)")
            time_data_layer(label, build_dataset(cfg, "train", seed=0))
            loader_rates(label, cfg)

        # nyu_train from files: Trainer.fit(1), 4 steps of b8, validation on 8 frames at b1
        save = os.path.join(root, "nyu_train")
        cfg = _files_cfg("nyu_train", manifests, root, save)
        train_loader, val_loader = build_loaders(cfg)
        train_loader = LoaderWaits(train_loader)
        trainer = Trainer(cfg, train_loader, val_loader, device="cuda")
        n_train, n_val = len(train_loader), len(val_loader)
        p0 = {k: v.detach().clone() for k, v in trainer.state.model.named_parameters()}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        val = trainer.fit(1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        per_fwd = d2s_per_forward(trainer.state.model)
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=n_train, cspn2d_tiled=n_val,
                        cspn2d_bwd=n_train, d2s=per_fwd * (n_train + n_val), s2d=per_fwd * n_train)
        log(f"  nyu_train from PNG files, Trainer.fit(1): {n_train} steps of "
            f"{cfg.data.batch_size_train}, {n_val} val batches of {cfg.data.batch_size_eval} in "
            f"{elapsed:.2f} s ({cfg.data.num_workers} {cfg.data.worker_mode} workers); launches "
            f"{launches} (expected {expected})")
        log(f"  nyu_train b8 from files: {train_loader.summary()}")
        if launches != expected:
            raise AssertionError(f"nyu_train from files launched {launches}, expected {expected}")
        moved = sum(not torch.equal(p, p0[k]) for k, p in trainer.state.model.named_parameters())
        if moved != len(p0) or not all(np.isfinite(v) for v in val.values()):
            raise AssertionError(f"{moved} of {len(p0)} parameter tensors moved; val {val}")
        log(f"  val MAE {val['MAE']:.4f} RMSE {val['RMSE']:.4f}; all {len(p0)} parameter tensors "
            "moved")
        by_path["files_train"] = launches
        del trainer, p0

        # nyu_eval from files: run_eval's 5 runs at b1 on the weights just trained
        ecfg = _files_cfg("nyu_eval", manifests, root, save)
        sparse = [build_dataset(ecfg, "val", seed=r)[0]["rgbd"][..., 3] for r in range(EVAL_RUNS)]
        if any(np.array_equal(sparse[i], sparse[j]) for i in range(EVAL_RUNS) for j in range(i)):
            raise AssertionError("two eval runs drew the same sparse input")
        reset_launches()
        t0 = time.perf_counter()
        res = run_eval(ecfg, runs=EVAL_RUNS, device="cuda")
        torch.cuda.synchronize()
        launches = read_launches()
        frames = EVAL_RUNS * NYU_FILES[1]
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_tiled=frames, d2s=per_fwd * frames)
        maes = [r["MAE"] for r in res["runs"]]
        log(f"  nyu_eval from PNG files, run_eval({EVAL_RUNS} runs of {NYU_FILES[1]} frames at b1) "
            f"in {time.perf_counter() - t0:.2f} s: MAE per run {', '.join(f'{m:.4f}' for m in maes)}; "
            f"launches {launches} (expected {expected}); the runs' sparse inputs differ")
        if launches != expected:
            raise AssertionError(f"nyu_eval from files launched {launches}, expected {expected}")
        if len(res["runs"]) != EVAL_RUNS or not all(np.isfinite(v) for r in res["runs"]
                                                     for v in r.values()):
            raise AssertionError(f"eval runs: {res['runs']}")
        by_path["files_eval"] = launches

        # nyu_mono: one b8 step on an all-zero sparse channel
        mcfg = _files_cfg("nyu_mono", manifests, root, os.path.join(root, "mono"))
        train_loader, val_loader = build_loaders(mcfg)
        trainer = Trainer(mcfg, train_loader, val_loader, device="cuda")
        batch = next(iter(train_loader))
        if batch["rgbd"][..., 3].any():
            raise AssertionError("nyu_mono's sparse channel is not all zero")
        reset_launches()
        loss, _ = trainer.train_step(*trainer._to_device(batch))
        loss = loss.item()
        launches = read_launches()
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=1, cspn2d_bwd=1, d2s=per_fwd,
                        s2d=per_fwd)
        log(f"  nyu_mono from PNG files (n_sample 0, an all-zero sparse channel): one b"
            f"{batch['rgbd'].shape[0]} step, loss {loss:.4f}; launches {launches} "
            f"(expected {expected})")
        if launches != expected or not np.isfinite(loss):
            raise AssertionError(f"nyu_mono step: loss {loss}, launches {launches}")
        by_path["files_mono"] = launches
        del trainer

        # kitti_benchmark from files: Trainer.fit(1), 4 steps of b4, validation at b1
        save = os.path.join(root, "kitti")
        cfg = _files_cfg("kitti_benchmark", manifests, root, save)
        train_loader, val_loader = build_loaders(cfg)
        train_loader = LoaderWaits(train_loader)
        trainer = Trainer(cfg, train_loader, val_loader, device="cuda")
        n_train, n_val = len(train_loader), len(val_loader)
        p0 = {k: v.detach().clone() for k, v in trainer.state.model.named_parameters()}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        val = trainer.fit(1)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        per_fwd = d2s_per_forward(trainer.state.model)
        expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=n_train, cspn2d_tiled=n_val,
                        cspn2d_bwd=n_train, d2s=per_fwd * (n_train + n_val), s2d=per_fwd * n_train)
        log(f"  kitti_benchmark from PNG files, Trainer.fit(1): {n_train} steps of "
            f"{cfg.data.batch_size_train}, {n_val} val batches of {cfg.data.batch_size_eval} in "
            f"{elapsed:.2f} s; launches {launches} (expected {expected})")
        log(f"  kitti_benchmark b4 from files: {train_loader.summary()}")
        if launches != expected:
            raise AssertionError(f"kitti_benchmark from files launched {launches}, expected {expected}")
        moved = sum(not torch.equal(p, p0[k]) for k, p in trainer.state.model.named_parameters())
        if moved != len(p0) or not all(np.isfinite(v) for v in val.values()):
            raise AssertionError(f"{moved} of {len(p0)} parameter tensors moved; val {val}")
        by_path["files_kitti"] = launches
        del trainer, p0

        # the eval subcommand, as a user runs it, on the weights just trained
        cmd = [sys.executable, "-m", "cspn_tpu_torch", "eval", "--preset", "kitti_benchmark",
               "--input-format", "img", "--eval-list", manifests["kitti", "val"], "--root-dir", root,
               "--best-model-dir", save, "--runs", "2"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=ROOT))
        if r.returncode != 0 or "eval_mean_of_2_runs" not in r.stdout:
            raise AssertionError(f"the eval subcommand exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                                 f"{r.stderr[-3000:]}")
        tail = r.stdout[r.stdout.index("eval_mean_of_2_runs"):].splitlines()[:2]
        log(f"  `python -m cspn_tpu_torch eval --preset kitti_benchmark --input-format img ... "
            f"--runs 2` exited 0 in {time.perf_counter() - t0:.1f} s: {' '.join(tail)}")

    new = sorted(set(loaded()) - set(before))
    if new:
        raise AssertionError(f"the file paths imported {new[:5]}: the PNG route needs neither")
    from cspn_tpu_torch.data import datasets, native

    if not native.available() or datasets._warned_no_library:
        raise AssertionError(f"a file path took the transforms chain (PIL route): the host library "
                             f"is not available here: {native.build_error()}")
    log("  this phase imported neither PIL nor h5py; every file path took the host library's "
        "route (none the transforms chain)")
    return by_path


def debug_nans_slice(name: str) -> dict:
    """Phase 5, `--debug-nans`: utils/profiling.py:debug_nans (what `train
    --debug-nans` turns on) over nyu_train b8 steps at 228x304 from seeded
    weights: a step on a synthetic batch stays finite and launches the
    train route's kernels, a step with a NaN put into its input raises
    FloatingPointError where the first conv's output holds it.  Returns the
    kernels' launches of the checked steps."""
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.utils.profiling import debug_nans

    cfg = _train_cfg("")
    n = cfg.data.batch_size_train
    model = build_model(cfg, train=True, device="cuda", seed=0)
    step = make_train_step(model, make_optimizer(model.parameters()))
    ds = SyntheticDepthDataset(length=n, hw=tuple(cfg.data.crop_hw), n_sample=cfg.data.n_sample,
                               seed=3)
    x, depth = (torch.from_numpy(np.stack([ds[i][k] for i in range(n)])).cuda()
                for k in ("rgbd", "depth"))
    step(x, depth)  # cuDNN's algorithm timing, unchecked
    torch.cuda.synchronize()
    reset_launches()
    debug_nans(True)
    try:
        t0 = time.perf_counter()
        loss = step(x, depth)[0].item()
        elapsed = time.perf_counter() - t0
        launches = read_launches()
        bad = x.clone()
        bad[0, 100, 150, 0] = float("nan")
        try:
            step(bad, depth)
        except FloatingPointError as e:
            raised = str(e)
        else:
            raise AssertionError("a train step on a NaN input raised nothing under --debug-nans")
    finally:
        debug_nans(False)
    per_fwd = d2s_per_forward(model)
    expected = dict(dict.fromkeys(KERNEL_NAMES, 0), cspn2d_fwd=1, cspn2d_bwd=1, d2s=per_fwd,
                    s2d=per_fwd)
    if not np.isfinite(loss) or launches != expected:
        raise AssertionError(f"--debug-nans step: loss {loss}, launches {launches} (expected "
                             f"{expected})")
    log(f"  --debug-nans (utils/profiling.py:debug_nans): a b{n} train step stays finite (loss "
        f"{loss:.4f}, {elapsed:.2f} s with every module's output checked and autograd's anomaly "
        f"mode; launches {launches}); a NaN in its input raises FloatingPointError: {raised}")
    return launches


def bench_slice(name: str) -> None:
    """Phase 16: `python -m cspn_tpu_torch bench` in a subprocess (the
    ResNet-50 CSPN-UNet at 228x304, b128, on the kernel, int8 and plain
    reference paths, each a captured CUDA graph of 8 chained forwards):
    exit code 0, exactly one stdout line holding the four keys with a
    positive value; echoes the line and the paths' frames/s."""
    torch.cuda.empty_cache()  # the bench process wants the card's memory
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cspn_tpu_torch", "bench"], capture_output=True,
                       text=True, timeout=900, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    elapsed = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"bench exited {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    lines = r.stdout.strip().splitlines()
    line = json.loads(lines[0]) if len(lines) == 1 else None
    if line is None or list(line) != ["metric", "value", "unit", "vs_baseline"] \
            or line["metric"] != "nyu_eval_frames_per_s" or not line["value"] > 0:
        raise AssertionError(f"bench printed {lines[:3]} on stdout: one line with metric, value, "
                             "unit and vs_baseline expected")
    for row in r.stderr.splitlines():
        if row.startswith("bench:"):
            log(f"  {row}")
    log(f"  `python -m cspn_tpu_torch bench` exited 0 in {elapsed:.1f} s; its line: {lines[0]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_smoke.py", description="the port's check on one card")
    p.add_argument("--routes-of", metavar="CHECKOUT",
                   help="only time the 2D CSPN, segment, probe and paddle kernels of "
                        "CHECKOUT's cspn_tpu_torch (routes_of) and print them")
    p.add_argument("--d2s-only", action="store_true",
                   help="with --routes-of: only the depth-to-space stages")
    p.add_argument("--steps-of", metavar="CHECKOUT",
                   help="only time the train steps and served frames/s of CHECKOUT's "
                        "cspn_tpu_torch (steps_of) and print them")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.routes_of is not None:
        return routes_of(args.routes_of, args.d2s_only)
    if args.steps_of is not None:
        return steps_of(args.steps_of)
    from cspn_tpu_torch import set_conv_policy
    from cspn_tpu_torch.ops import _build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    set_conv_policy("cuda")  # the entry points' default policy, before the first convolution
    log(f"[1/16] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}, "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; L2 "
        f"{torch.cuda.get_device_properties(0).L2_cache_size} B")

    t0 = time.perf_counter()
    _build.build()
    host = _build.build_seconds.get("host_pipeline")
    log(f"[2/16] built {sorted(_build.KERNELS)} (nvcc) and {sorted(_build.HOST_LIBRARIES)} (g++, "
        f"{'already built' if host is None else f'{host:.1f} s'}) in {time.perf_counter() - t0:.1f} s")

    log("[3/16] kernels against their plain versions")
    tiled = check_tiled_kernel(name)
    rows = [check_cspn_kernel(name), check_cspn_bwd_kernel(name), check_cspn3d_kernel(name),
            check_cspn3d_bwd_kernel(name), *check_d2s_kernels(name), tiled,
            check_paddle2d_kernel(name), check_step_probe(name), *check_halo_seg_kernels(name)]
    check_cspn3d_bf16_gates(name, rows[2], rows[3])
    tiled["fwd_routes"] = time_fwd_routes(name)
    kernel_ms = {r["name"]: r["ms"] for r in rows}
    kernel_ms["cspn3d_fwd_kept"] = rows[2]["kept_states_ms"]  # the training forward
    train_ms = {tuple(r["shape"]): r["train_kept_ms"] for r in tiled["fwd_routes"]}
    kernel_ms["cspn2d_train_nyu"], kernel_ms["cspn2d_train_kitti"] = (train_ms[MAIN_SHAPE],
                                                                      train_ms[KITTI_SHAPE])

    log("[4/16] nyu_eval served through DepthServer")
    by_path = {"serve": serve_slice(name)}

    log("[5/16] nyu_train trained through Trainer.fit, and a --debug-nans step")
    by_path["train"] = train_slice(name, kernel_ms)
    by_path["debug_nans"] = debug_nans_slice(name)

    log("[6/16] stereo (PSMNet + 3D CSPN) evaluated through StereoTrainer.run_eval")
    by_path["stereo_eval"] = stereo_eval_slice(name)

    log("[7/16] stereo (PSMNet + 3D CSPN) trained through StereoTrainer.fit")
    by_path["stereo_train"] = stereo_train_slice(name, kernel_ms)

    log("[8/16] kitti_benchmark (ResNet-18, 352x1216) served through DepthServer")
    by_path["kitti_serve"] = kitti_serve_slice(name)

    log("[9/16] kitti_benchmark trained through Trainer.fit")
    by_path["kitti_train"] = kitti_train_slice(name, kernel_ms)

    log("[10/16] the demo subcommand (dims 2 and 3) and the step-body probe")
    by_path["demo2d"] = demo_slice(name, 2)
    by_path["demo3d"] = demo_slice(name, 3)
    by_path["probe"] = probe_slice(name)

    log("[11/16] the spatially sharded CSPN (in-process meshes) on kitti_benchmark and stereo")
    check_sharded_op(name)
    by_path["kitti_sharded"] = sharded_kitti_slice(name)
    by_path["stereo_sharded"] = sharded_stereo_slice(name)

    log("[12/16] data-parallel nyu_train through DDP (1-rank NCCL group), and bench-scaling")
    by_path["ddp"] = ddp_slice(name)

    log("[13/16] precision: bf16 and int8 serving through load_server, bf16 training")
    from cspn_tpu_torch.utils.profiling import nyu_eval_synthetic

    serve = [precision_serve(name, "nyu_eval", nyu_eval_synthetic(), PRECISION_BUCKETS,
                             PRECISION_INT8_FROM, PRECISION_REQUESTS, 8),
             precision_serve(name, "kitti_benchmark", _kitti_cfg(), KITTI_BUCKETS, KITTI_INT8_FROM,
                             KITTI_PRECISION_REQUESTS, KITTI_BUCKETS[-1])]
    by_path["precision_serve"] = {k: sum(c[k] for c in serve) for k in KERNEL_NAMES}
    by_path["precision_train"] = precision_train(name)

    log("[14/16] deployment: reference-checkpoint import, export to torch.export artifacts, "
        "image dumps")
    by_path["deploy"] = deployment_slice(name)

    log("[15/16] the NYU and KITTI file datasets: nyu_train, nyu_eval, kitti_benchmark and "
        "nyu_mono fed from PNG files")
    by_path.update(files_slice(name))

    log("[16/16] the bench subcommand: nyu_eval frames/s through captured CUDA graphs")
    bench_slice(name)

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
