"""Step timing, tracing, and where a nyu_eval forward spends its device time
(counterpart of cspn_tpu/utils/profiling.py, on CUDA events and
torch.profiler).

    python -m cspn_tpu_torch.utils.profiling [--stereo | --kitti] [--train]
        [--decoder subpixel|plain] [--batch N] [--reps 5] [--cudnn-heuristic] [--tf32]
        [--out FILE.json]

  - `StepTimer`: per-step time (CUDA events on the card, the wall clock on
    the CPU) with a warm-up skip, median and frames/s;
  - `trace(logdir)`: a torch.profiler trace of the block, written to
    `logdir/trace.json` (chrome://tracing, Perfetto);
  - `train_step_split_ms`: a train step's forward, backward and optimizer
    time by CUDA events;
  - `debug_nans(enable)`: raise where a forward first gives a NaN (the
    counterpart of jax_debug_nans);
  - `decoder_twin`: a CSPN-UNet's weights in the other decoder form.

The module's main builds the nyu_eval ResNet-50 CSPN-UNet (228x304, 24
steps; the decoder in its subpixel form, or plain with `--decoder plain`),
or with `--kitti` the kitti_benchmark ResNet-18 one (352x1216, batch 4 by
default), with seeded random weights and BN statistics calibrated on one
synthetic batch, then, on the card:
  - times each top-level module of a forward with CUDA events recorded in
    forward hooks (median over `reps` forwards); the rest of the forward
    (input relayout, the fused head conv and the CSPN) is the total minus
    their sum; in the subpixel form also the weight reindex the blocks do
    (`reindex_ms`, timed on its own);
  - traces `reps` forwards with torch.profiler and sums the device time of
    every kernel, grouped by kind (conv/matmul, batch norm, the CSPN
    kernels, `d2s` and `s2d`, other).
With `--train` it profiles a nyu_train step instead: forward, backward and
optimizer by CUDA events, and the kernels by kind.  With `--stereo` it
builds the stereo model at StereoConfig width (PSMNetCSPN, max_disp 192,
features 32, 24 steps; seeded random weights, BN statistics calibrated on
one synthetic batch) on synthetic 256x512 pairs, batch 4 by default, and
times each stage of a forward (models/stereo.py:STAGES: feature extractor,
cost volume, hourglass, heads, 3D CSPN, upsample + regression) with CUDA
events between them; `--stereo --train` splits a stereo train step and
times the 3D CSPN's gate normalization and relayouts around its kernels
(`cspn3d_glue_ms`).
Prints the tables with the card's name and power limit and the peak device
memory (with and without the first calls' cuDNN algorithm search), and
writes them to `--out` as JSON.  The convolution policy is the entry
points' (`cspn_tpu_torch.set_conv_policy`: cuDNN times its algorithms,
IEEE float32), set before the first convolution; `--cudnn-heuristic`
turns the timing off and `--tf32` turns TF32 on.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import time
from typing import Iterator

import numpy as np
import torch

from cspn_tpu_torch import set_conv_policy
from cspn_tpu_torch.config import PRESETS, RunConfig
from cspn_tpu_torch.data import SyntheticDepthDataset
from cspn_tpu_torch.train.evaluate import build_model, calibrate_bn_stats

NYU_HW = (228, 304)


def nyu_eval_synthetic() -> RunConfig:
    """The nyu_eval preset on the synthetic dataset at NYU geometry."""
    cfg = PRESETS["nyu_eval"]
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset="synthetic", crop_hw=NYU_HW)
    )


def calibrated_model(cfg: RunConfig, device="cuda", seed: int = 0, calib_batch: int = 8):
    """Seeded random weights, BN statistics of one synthetic batch, eval mode."""
    model = build_model(cfg, train=True, device=device, seed=seed)
    ds = SyntheticDepthDataset(length=calib_batch, hw=tuple(cfg.data.crop_hw),
                               n_sample=cfg.data.n_sample, seed=seed)
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(calib_batch)]))
    return calibrate_bn_stats(model, x.to(next(model.parameters()).device))


def decoder_twin(model, subpixel: bool):
    """`model` (a CSPNUNet) with its decoder in the given form
    (models/decoder.py): the same settings, weights, BN statistics, device,
    dtype and mode."""
    from cspn_tpu_torch.models.unet import CSPNUNet

    p = next(model.parameters())
    with torch.device(p.device):
        twin = CSPNUNet(model.block, model.layers, model.cspn_steps, model.cspn_norm_type,
                        model.use_cspn, model.cspn_backend, model.cspn_io_dtype,
                        subpixel=subpixel)
    twin = twin.to(p.dtype)
    twin.load_state_dict(model.state_dict())
    return twin.train(model.training)


def reindex_ms(model, reps: int = 5) -> float:
    """Median device ms of the subpixel weight reindex one forward of
    `model` does: the kernels of every decoder SubpixelUnpoolConv and of
    the fused head (decoder._subpixel_convs), copied contiguous as the
    conv takes them."""
    from cspn_tpu_torch.models import decoder

    weights = [m.weight for name, m in model.named_modules()
               if isinstance(m, decoder.SubpixelUnpoolConv)
               and not name.startswith(("gud_up_proj_layer5", "gud_up_proj_layer6"))]
    heads = torch.cat([model.gud_up_proj_layer5.conv1.weight, model.gud_up_proj_layer6.conv1.weight])

    def run():
        for w in (*weights, heads):
            for kernel, _, _ in decoder._subpixel_convs(w):
                kernel.contiguous()

    times = []
    with torch.no_grad():
        run()
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


class StepTimer:
    """Step timer with warm-up; reports median step time and frames/s.
    On a CUDA device each step is timed by CUDA events (read, and so
    synchronized, only when the times are asked for); on the CPU by the
    wall clock.  Usage:

        timer = StepTimer(warmup=2, device=dev)
        for batch in loader:
            with timer.step(batch_size):
                run_step(...)
        print(timer.summary())
    """

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._marks: list = []  # (start, end) events or seconds per timed step
        self.samples: list[int] = []
        self._n = 0

    @contextlib.contextmanager
    def step(self, batch_size: int = 1) -> Iterator[None]:
        self._n += 1
        timed = self._n > self.warmup
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._marks.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            if timed:
                self._marks.append(time.perf_counter() - t0)
        if timed:
            self.samples.append(batch_size)

    @property
    def times(self) -> list[float]:
        """Seconds per timed step."""
        if self.cuda and self._marks:
            self._marks[-1][1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in self._marks]
        return list(self._marks)

    @property
    def median_step_s(self) -> float:
        return statistics.median(self.times) if self._marks else float("nan")

    @property
    def frames_per_s(self) -> float:
        total = sum(self.times)
        return sum(self.samples) / total if total > 0 else float("nan")

    def summary(self) -> str:
        if not self._marks:
            return "StepTimer: no timed steps"
        times = self.times
        return (
            f"steps={len(times)} mean={sum(times) / len(times) * 1e3:.1f}ms "
            f"median={self.median_step_s * 1e3:.1f}ms throughput={self.frames_per_s:.1f} frames/s"
        )


_nan_hook = None  # debug_nans' global forward hook, while it is on


def _floats(value) -> Iterator[torch.Tensor]:
    """The floating-point tensors in a module's output (a tensor, or
    tuples, lists and dicts of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_floating_point():
            yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _floats(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _floats(v)


def _raise_on_nan(module, inputs, output) -> None:
    for t in _floats(output):
        if torch.isnan(t).any():
            raise FloatingPointError(
                f"NaN in the output {tuple(t.shape)} of {module._get_name()}"
                f"({module.extra_repr()}), the first module whose forward gave one")


def debug_nans(enable: bool = True) -> None:
    """NaN checking, the counterpart of jax_debug_nans
    (cspn_tpu/utils/profiling.py:31-33).  On: a global module forward hook
    raises FloatingPointError naming the first module whose output holds a
    NaN (modules finish inside out, so the innermost one; each output is
    read on the host, a synchronization a module), and autograd's anomaly
    mode checks every backward function's output for NaNs (its error names
    the function and carries its forward's traceback).  `debug_nans(False)`
    removes both.  A CUDA graph cannot be captured while it is on."""
    global _nan_hook
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    if enable and _nan_hook is None:
        _nan_hook = torch.nn.modules.module.register_module_forward_hook(_raise_on_nan)
    elif not enable and _nan_hook is not None:
        _nan_hook.remove()
        _nan_hook = None


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (the card too, when there is
    one) and write `logdir/trace.json`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def train_step_split_ms(model, optimizer, loss_fn, inputs, target, reps: int = 5) -> dict[str, float]:
    """Median device ms of a train step's forward (with the loss), backward
    and optimizer step, CUDA events between them, after one warm-up step.
    `inputs` is the model's input tensor, or a tuple of them."""
    inputs = inputs if isinstance(inputs, tuple) else (inputs,)
    marks = []
    model.train()
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        loss = loss_fn(model(*inputs), target)
        ev[1].record()
        loss.backward()
        ev[2].record()
        optimizer.step()
        ev[3].record()
        if r:
            marks.append(ev)
    torch.cuda.synchronize()
    out = {}
    for name, i in (("forward", 0), ("backward", 1), ("optimizer", 2)):
        out[name] = statistics.median(e[i].elapsed_time(e[i + 1]) for e in marks)
    out["step"] = statistics.median(e[0].elapsed_time(e[3]) for e in marks)
    return out


def _kind(kernel: str) -> str:
    k = kernel.lower()
    # the subpixel decoder's depth-to-space kernels (csrc/d2s.cu) and their
    # adjoints, before the CSPN kinds and the convs
    if "d2s_copy_kernel" in k:
        return "d2s"
    if "s2d_copy_kernel" in k:
        return "s2d"
    # the tile kernels (csrc/cspn2d_tiled.cu, csrc/paddle2d.cu) and the probe
    if "cspn2d_tiled_kernel" in k:
        return "cspn2d_tiled"
    if "paddle2d_kernel" in k:
        return "paddle2d"
    if "step_probe" in k:
        return "step_probe"
    # the 3D kernels first: their names hold the 2D ones' substrings
    if "cspn3d_" in k:  # the forward's sweep; the backward's reverse sweep and gate pass
        return "cspn3d_fwd" if "cspn3d_fwd_sweep_kernel" in k else "cspn3d_bwd"
    # the sharded segment's forward (either route), and its backward's
    # reverse tiles and keep epilogue, before the 2D backward's epilogue
    if "halo_seg_kernel" in k:
        return "cspn2d_halo_seg"
    if "halo_seg_" in k or "keep_epilogue_kernel" in k:
        return "cspn2d_halo_seg_bwd"
    # the backward's replay, reverse tiles and epilogue
    if "replay_tile_kernel" in k or "reverse_tile_kernel" in k or "epilogue_kernel" in k:
        return "cspn2d_bwd"
    if "cspn2d_fwd_kernel" in k:  # the forward that keeps its states
        return "cspn2d_fwd"
    if any(s in k for s in ("conv", "gemm", "xmma", "implicit", "cutlass", "fprop", "dgrad",
                            "wgrad", "winograd", "fft")):
        return "conv/matmul"
    if "norm" in k or "bn_" in k:
        return "batch norm"
    return "other"


def module_times_ms(model, x, reps: int = 5) -> dict[str, float]:
    """Median device ms of each top-level module, and of the whole forward."""
    events: dict[str, list] = {}
    hooks = []
    for name, mod in model.named_children():
        def pre(_m, _i, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.setdefault(name, []).append([ev, None])

        def post(_m, _i, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    totals = []
    try:
        with torch.inference_mode():
            model(x)  # warm-up
            events.clear()
            for _ in range(reps):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                model(x)
                end.record()
                totals.append((start, end))
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    # each top-level module runs once per forward
    out = {name: statistics.median(a.elapsed_time(b) for a, b in pairs)
           for name, pairs in events.items()}
    total = statistics.median(a.elapsed_time(b) for a, b in totals)
    out["rest (relayout, head conv, CSPN)"] = total - sum(out.values())
    out["forward"] = total
    return out


def kernel_kinds_ms(fn, reps: int = 5) -> tuple[dict[str, float], list]:
    """Device ms per call of `fn()` by kernel kind, and the ten longest
    kernels, from a torch.profiler trace of `reps` calls after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in prof.events():
        # a user annotation (e.g. Optimizer.step) spans kernels counted on their own
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.elapsed_us()
        by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + us / 1e3 / reps
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return by_kind, top


STEREO_HW = (256, 512)


def stereo_batch(cfg, n: int, seed: int = 1, device="cuda"):
    """(left, right, disp) of `n` synthetic stereo pairs at STEREO_HW."""
    from cspn_tpu_torch.data import SyntheticStereoDataset

    ds = SyntheticStereoDataset(length=n, hw=STEREO_HW, max_disp=cfg.max_disp, seed=seed)
    return tuple(torch.from_numpy(np.stack([ds[i][k] for i in range(n)])).to(device)
                 for k in ("left", "right", "disp"))


def calibrated_stereo_model(cfg, device="cuda", seed: int = 0, calib_batch: int = 4):
    """The stereo model with seeded random weights and the BN statistics of
    one synthetic batch, in eval mode."""
    from cspn_tpu_torch.train.stereo_loop import build_stereo_model

    model = build_stereo_model(cfg, train=True, device=device, seed=seed)
    left, right, _ = stereo_batch(cfg, calib_batch, seed=seed, device=device)
    return calibrate_bn_stats(model, left, right)


def stereo_stage_times_ms(model, left, right, reps: int = 5) -> dict[str, float]:
    """Median device ms of each stage of a stereo forward (CUDA events
    recorded between the stages), and of the whole forward."""
    from cspn_tpu_torch.models.stereo import STAGES

    runs = []
    with torch.inference_mode():
        for r in range(reps + 1):
            marks = [torch.cuda.Event(enable_timing=True)]
            marks[0].record()

            def mark(_stage, marks=marks):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

            model(left, right, mark=mark)
            if r:  # the first forward warms up
                runs.append(marks)
        torch.cuda.synchronize()
    out = {stage: statistics.median(m[i].elapsed_time(m[i + 1]) for m in runs)
           for i, stage in enumerate(STAGES)}
    out["forward"] = statistics.median(m[0].elapsed_time(m[-1]) for m in runs)
    return out


def cspn3d_glue_ms(n: int, d: int, h: int, w: int, steps: int, reps: int = 5) -> dict[str, float]:
    """The stereo model's 3D CSPN as models/stereo.py calls it (the 26
    guidance channels and the logits of its [n, 27, d, h, w] heads, channels
    first) forward and backward, against its two kernels alone on the same
    gates: the difference is the gate normalization (abs, sum, quotient and
    their backward) and the relayouts around the kernels.  CUDA events,
    median of `reps`."""
    from cspn_tpu_torch.ops import cspn3d_cuda, cspn_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    heads = torch.randn(n, 27, d, h, w, device="cuda", generator=gen)
    ct = torch.randn(n, 1, d, h, w, device="cuda", generator=gen)
    gates = cspn_ref.normalize_gates_nd(heads[:, 1:].movedim(1, -1), 26)
    gates = gates.permute(0, 4, 5, 1, 2, 3).flatten(0, 1).contiguous()
    x0, ct0 = heads[:, 0].contiguous(), ct[:, 0].contiguous()

    def module():
        hd = heads.detach().requires_grad_(True)
        out = cspn3d_cuda.cspn3d_cuda(hd[:, 1:], hd[:, :1], steps=steps, channel_first=True)
        torch.autograd.grad(out, hd, ct)

    def kernels():
        states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)[1]
        cspn3d_cuda._launch_bwd(gates, x0, states, ct0, steps)

    out = {}
    for name, fn in (("module_ms", module), ("kernels_ms", kernels)):
        fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = statistics.median(times)
    out["glue_ms"] = out["module_ms"] - out["kernels_ms"]
    return out


def _print_tables(title: str, what: str, by: str, table: dict, total: str, kinds: dict,
                  top: list) -> None:
    """Print `table` (device ms by `by`, shares of table[total]), then the
    kernel kinds and the ten longest kernels."""
    print(title)
    print(f"device ms per {what} by {by} (CUDA events, median of reps):")
    for name, ms in table.items():
        print(f"  {name:34s} {ms:9.3f}  {100 * ms / table[total]:5.1f}%")
    traced = sum(kinds.values())
    print(f"device ms per {what} by kernel kind (torch.profiler, {traced:.3f} ms traced):")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:52s} {ms:9.3f}  {100 * ms / max(traced, 1e-9):5.1f}%")
    print(f"ten longest kernels (ms per {what}):")
    for name, ms in top:
        print(f"  {ms:9.3f}  {name[:110]}")


def _warm_kinds(fn, reps: int):
    """kernel_kinds_ms(fn, reps) and device memory in GiB: the peak up to
    and over these warm calls (the first calls' cuDNN algorithm search
    included), and the peak of the warm calls alone."""
    first = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    kinds, top = kernel_kinds_ms(fn, reps)
    warm = torch.cuda.max_memory_allocated() / 2**30
    return kinds, top, {"peak_gib": max(first, warm), "warm_peak_gib": warm}


def _precision(args) -> str:
    return f"float32 (TF32 {'on' if args.tf32 else 'off'})"


def _stereo(args, card: str) -> dict:
    from cspn_tpu_torch.models.stereo import smooth_l1_disparity_loss
    from cspn_tpu_torch.train.stereo_loop import (
        StereoConfig,
        build_stereo_model,
        make_stereo_train_step,
    )
    from cspn_tpu_torch.train.state import make_optimizer

    cfg = StereoConfig()
    n = args.batch or cfg.batch_size
    left, right, disp = stereo_batch(cfg, n)
    result = {"card": card, "batch": n, "hw": STEREO_HW, "max_disp": cfg.max_disp,
              "features": cfg.features, "cspn_steps": cfg.cspn_steps,
              "cudnn_benchmark": not args.cudnn_heuristic, "tf32": args.tf32}
    what = (f"PSMNetCSPN max_disp {cfg.max_disp}, features {cfg.features}, {cfg.cspn_steps} CSPN "
            f"steps, batch {n}, {STEREO_HW[0]}x{STEREO_HW[1]}, {_precision(args)}, "
            f"cudnn.benchmark={not args.cudnn_heuristic} on {card}")
    if args.train:
        model = build_stereo_model(cfg, train=True, device="cuda", seed=0)
        optimizer = make_optimizer(model.parameters(), cfg.lr, momentum=0.9, weight_decay=1e-4,
                                   nesterov=False)

        def loss_fn(out, d):
            return smooth_l1_disparity_loss(out, d, cfg.max_disp)

        split = train_step_split_ms(model, optimizer, loss_fn, (left, right), disp, args.reps)
        step = make_stereo_train_step(model, optimizer, cfg.max_disp)
        kinds, top, mem = _warm_kinds(lambda: step(left, right, disp), args.reps)
        _print_tables(f"stereo train step, {what}", "train step", "phase", split, "step", kinds, top)
        glue = cspn3d_glue_ms(n, cfg.max_disp // 4, STEREO_HW[0] // 4, STEREO_HW[1] // 4,
                              cfg.cspn_steps, args.reps)
        print(f"3D CSPN forward + backward as the model calls it: {glue['module_ms']:.3f} ms, its "
              f"two kernels {glue['kernels_ms']:.3f} ms, the gate normalization and relayouts "
              f"{glue['glue_ms']:.3f} ms ({100 * glue['glue_ms'] / split['step']:.2f}% of the step)")
        return dict(result, phases_ms=split, kernel_kinds_ms=kinds, top_kernels_ms=top, memory=mem,
                    cspn3d_glue_ms=glue)
    model = calibrated_stereo_model(cfg)
    stages = stereo_stage_times_ms(model, left, right, args.reps)

    def forward():
        with torch.inference_mode():
            model(left, right)

    kinds, top, mem = _warm_kinds(forward, args.reps)
    _print_tables(f"stereo forward, {what}", "forward", "stage", stages, "forward", kinds, top)
    return dict(result, stages_ms=stages, kernel_kinds_ms=kinds, top_kernels_ms=top, memory=mem)


def kitti_benchmark_synthetic() -> RunConfig:
    """The kitti_benchmark preset (ResNet-18, 352x1216) on the synthetic
    dataset at KITTI geometry."""
    cfg = PRESETS["kitti_benchmark"]
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="synthetic"))


def _depth(args, card: str) -> dict:
    """nyu_eval / nyu_train, or kitti_benchmark with --kitti."""
    if args.kitti:
        cfg, train_cfg, run, batch = (kitti_benchmark_synthetic(), kitti_benchmark_synthetic(),
                                      "kitti_benchmark", args.batch or 4)
    else:
        cfg, train_cfg, run, batch = nyu_eval_synthetic(), PRESETS["nyu_train"], "nyu", args.batch or 8
    hw = tuple(cfg.data.crop_hw)
    ds = SyntheticDepthDataset(length=batch, hw=hw, n_sample=cfg.data.n_sample, seed=1)
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(batch)])).cuda()
    subpixel = args.decoder == "subpixel"
    result = {"card": card, "batch": batch, "hw": hw, "decoder": args.decoder, "run": run,
              "cudnn_benchmark": not args.cudnn_heuristic, "tf32": args.tf32}
    form = f"{args.decoder} decoder, cudnn.benchmark={not args.cudnn_heuristic}"
    if args.train:
        from cspn_tpu_torch.train.loop import make_train_step
        from cspn_tpu_torch.train.loss import masked_l1_loss
        from cspn_tpu_torch.train.state import make_optimizer

        depth = torch.from_numpy(np.stack([ds[i]["depth"] for i in range(batch)])).cuda()
        model = build_model(train_cfg, train=True, device="cuda", seed=0)
        if not subpixel:
            model = decoder_twin(model, False)
        optimizer = make_optimizer(model.parameters())
        split = train_step_split_ms(model, optimizer, masked_l1_loss, x, depth, args.reps)
        step = make_train_step(model, optimizer)
        kinds, top, mem = _warm_kinds(lambda: step(x, depth), args.reps)
        _print_tables(f"{run} train step, batch {batch}, {hw[0]}x{hw[1]}, {form}, "
                      f"{_precision(args)} on {card}", "train step", "phase", split, "step", kinds,
                      top)
        return dict(result, phases_ms=split, kernel_kinds_ms=kinds, top_kernels_ms=top, memory=mem)
    model = calibrated_model(cfg, calib_batch=batch)
    if not subpixel:
        model = decoder_twin(model, False)
    modules = module_times_ms(model, x, args.reps)
    if subpixel:
        modules["of which the weight reindex"] = reindex_ms(model, args.reps)

    def forward():
        with torch.inference_mode():
            model(x)

    kinds, top, mem = _warm_kinds(forward, args.reps)
    _print_tables(f"{run} forward, batch {batch}, {hw[0]}x{hw[1]}, {form}, "
                  f"{_precision(args)} on {card}", "forward", "module", modules, "forward", kinds, top)
    return dict(result, modules_ms=modules, kernel_kinds_ms=kinds, top_kernels_ms=top, memory=mem)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.utils.profiling")
    p.add_argument("--batch", type=int, default=None,
                   help="frames per batch (default 8 for nyu_eval/nyu_train, 4 for --stereo "
                        "and --kitti)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--train", action="store_true",
                   help="profile a train step (forward, backward, SGD) instead of a forward")
    p.add_argument("--decoder", choices=("subpixel", "plain"), default="subpixel",
                   help="the CSPN-UNet decoder's form (models/decoder.py; default subpixel)")
    p.add_argument("--stereo", action="store_true",
                   help="profile the PSMNet + 3D-CSPN stereo model instead of nyu_eval/nyu_train")
    p.add_argument("--kitti", action="store_true",
                   help="profile kitti_benchmark (ResNet-18, 352x1216) instead of nyu_eval/nyu_train")
    p.add_argument("--cudnn-heuristic", action="store_true",
                   help="let cuDNN's heuristic pick the conv algorithms instead of timing them "
                        "(cspn_tpu_torch.set_conv_policy's autotune off)")
    p.add_argument("--tf32", action="store_true",
                   help="float32 convolutions and matmuls in TF32, as the entry points' --tf32")
    p.add_argument("--out", default=None, help="write the tables here as JSON")
    args = p.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    # before the first convolution
    set_conv_policy("cuda", autotune=not args.cudnn_heuristic, tf32=args.tf32)
    torch.cuda.reset_peak_memory_stats()
    result = _stereo(args, card) if args.stereo else _depth(args, card)
    print(f"peak device memory {result['memory']['peak_gib']:.3f} GiB (cuDNN's algorithm search "
          f"included), {result['memory']['warm_peak_gib']:.3f} GiB over warm calls")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
