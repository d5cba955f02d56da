"""Step timing, tracing, and where a nyu_eval forward spends its device time
(counterpart of cspn_tpu/utils/profiling.py, on CUDA events and
torch.profiler).

    python -m cspn_tpu_torch.utils.profiling [--stereo] [--train] [--batch N] [--reps 5] [--out FILE.json]

  - `StepTimer`: per-step time (CUDA events on the card, the wall clock on
    the CPU) with a warm-up skip, median and frames/s;
  - `trace(logdir)`: a torch.profiler trace of the block, written to
    `logdir/trace.json` (chrome://tracing, Perfetto);
  - `train_step_split_ms`: a train step's forward, backward and optimizer
    time by CUDA events.

The module's main builds the nyu_eval ResNet-50 CSPN-UNet (228x304, 24
steps) with seeded random weights and BN statistics calibrated on one
synthetic batch, then, on the card:
  - times each top-level module of a forward with CUDA events recorded in
    forward hooks (median over `reps` forwards); the rest of the forward
    (input relayout, the fused head conv and the CSPN) is the total minus
    their sum;
  - traces `reps` forwards with torch.profiler and sums the device time of
    every kernel, grouped by kind (conv/matmul, batch norm, the CSPN
    kernels, other).
With `--train` it profiles a nyu_train step instead: forward, backward and
optimizer by CUDA events, and the kernels by kind.  With `--stereo` it
builds the stereo model at StereoConfig width (PSMNetCSPN, max_disp 192,
features 32, 24 steps; seeded random weights, BN statistics calibrated on
one synthetic batch) on synthetic 256x512 pairs, batch 4 by default, and
times each stage of a forward (models/stereo.py:STAGES: feature extractor,
cost volume, hourglass, heads, 3D CSPN, upsample + regression) with CUDA
events between them; `--stereo --train` splits a stereo train step.
Prints the tables with the card's name and power limit and writes them to
`--out` as JSON.
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
    # the 3D kernels first: their names hold the 2D ones' substrings
    if "cspn3d_" in k:  # in a train step the step kernel is also the backward's replay
        return "cspn3d_fwd" if "cspn3d_step_kernel" in k else "cspn3d_bwd"
    if "reverse_step_kernel" in k or "epilogue_kernel" in k or "unshift_kernel" in k:
        return "cspn2d_bwd"
    if "prep_kernel" in k or "step_kernel" in k:  # in a train step also the backward's replay
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
              "features": cfg.features, "cspn_steps": cfg.cspn_steps}
    what = (f"PSMNetCSPN max_disp {cfg.max_disp}, features {cfg.features}, {cfg.cspn_steps} CSPN "
            f"steps, batch {n}, {STEREO_HW[0]}x{STEREO_HW[1]}, float32 (TF32 off) on {card}")
    if args.train:
        model = build_stereo_model(cfg, train=True, device="cuda", seed=0)
        optimizer = make_optimizer(model.parameters(), cfg.lr, momentum=0.9, weight_decay=1e-4,
                                   nesterov=False)

        def loss_fn(out, d):
            return smooth_l1_disparity_loss(out, d, cfg.max_disp)

        split = train_step_split_ms(model, optimizer, loss_fn, (left, right), disp, args.reps)
        step = make_stereo_train_step(model, optimizer, cfg.max_disp)
        kinds, top = kernel_kinds_ms(lambda: step(left, right, disp), args.reps)
        _print_tables(f"stereo train step, {what}", "train step", "phase", split, "step", kinds, top)
        return dict(result, phases_ms=split, kernel_kinds_ms=kinds, top_kernels_ms=top)
    model = calibrated_stereo_model(cfg)
    stages = stereo_stage_times_ms(model, left, right, args.reps)

    def forward():
        with torch.inference_mode():
            model(left, right)

    kinds, top = kernel_kinds_ms(forward, args.reps)
    _print_tables(f"stereo forward, {what}", "forward", "stage", stages, "forward", kinds, top)
    return dict(result, stages_ms=stages, kernel_kinds_ms=kinds, top_kernels_ms=top)


def _nyu(args, card: str) -> dict:
    cfg = nyu_eval_synthetic()
    batch = args.batch or 8
    ds = SyntheticDepthDataset(length=batch, hw=NYU_HW, n_sample=cfg.data.n_sample, seed=1)
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(batch)])).cuda()
    result = {"card": card, "batch": batch, "hw": NYU_HW}
    if args.train:
        from cspn_tpu_torch.train.loop import make_train_step
        from cspn_tpu_torch.train.loss import masked_l1_loss
        from cspn_tpu_torch.train.state import make_optimizer

        depth = torch.from_numpy(np.stack([ds[i]["depth"] for i in range(batch)])).cuda()
        model = build_model(PRESETS["nyu_train"], train=True, device="cuda", seed=0)
        optimizer = make_optimizer(model.parameters())
        split = train_step_split_ms(model, optimizer, masked_l1_loss, x, depth, args.reps)
        step = make_train_step(model, optimizer)
        kinds, top = kernel_kinds_ms(lambda: step(x, depth), args.reps)
        _print_tables(f"nyu_train train step, batch {batch}, {NYU_HW[0]}x{NYU_HW[1]}, float32 "
                      f"(TF32 off) on {card}", "train step", "phase", split, "step", kinds, top)
        return dict(result, phases_ms=split, kernel_kinds_ms=kinds, top_kernels_ms=top)
    model = calibrated_model(cfg)
    modules = module_times_ms(model, x, args.reps)

    def forward():
        with torch.inference_mode():
            model(x)

    kinds, top = kernel_kinds_ms(forward, args.reps)
    _print_tables(f"nyu_eval forward, batch {batch}, {NYU_HW[0]}x{NYU_HW[1]}, float32 "
                  f"(TF32 off) on {card}", "forward", "module", modules, "forward", kinds, top)
    return dict(result, modules_ms=modules, kernel_kinds_ms=kinds, top_kernels_ms=top)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.utils.profiling")
    p.add_argument("--batch", type=int, default=None,
                   help="frames per batch (default 8 for nyu_eval/nyu_train, 4 for --stereo)")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--train", action="store_true",
                   help="profile a train step (forward, backward, SGD) instead of a forward")
    p.add_argument("--stereo", action="store_true",
                   help="profile the PSMNet + 3D-CSPN stereo model instead of nyu_eval/nyu_train")
    p.add_argument("--out", default=None, help="write the tables here as JSON")
    args = p.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = _stereo(args, card) if args.stereo else _nyu(args, card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
