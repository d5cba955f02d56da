"""Where a nyu_eval forward spends its device time (counterpart of
cspn_tpu/utils/profiling.py, on CUDA events and torch.profiler).

    python -m cspn_tpu_torch.utils.profiling [--batch 8] [--reps 5] [--out FILE.json]

Builds the nyu_eval ResNet-50 CSPN-UNet (228x304, 24 steps) with seeded
random weights and BN statistics calibrated on one synthetic batch, then,
on the card:
  - times each top-level module of a forward with CUDA events recorded in
    forward hooks (median over `reps` forwards); the rest of the forward
    (input relayout, the fused head conv and the CSPN) is the total minus
    their sum;
  - traces `reps` forwards with torch.profiler and sums the device time of
    every kernel, grouped by kind (conv/matmul, batch norm, the CSPN
    kernel, other).
Prints both tables with the card's name and power limit and writes them to
`--out` as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

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


def _kind(kernel: str) -> str:
    k = kernel.lower()
    if "prep_kernel" in k or "step_kernel" in k:
        return "cspn2d_fwd"
    if any(s in k for s in ("conv", "gemm", "xmma", "implicit", "cutlass", "fprop", "winograd", "fft")):
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


def kernel_kinds_ms(model, x, reps: int = 5) -> tuple[dict[str, float], list]:
    """Device ms per forward by kernel kind, and the ten longest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + us / 1e3 / reps
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return by_kind, top


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.utils.profiling")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None, help="write the tables here as JSON")
    args = p.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = nyu_eval_synthetic()
    model = calibrated_model(cfg)
    ds = SyntheticDepthDataset(length=args.batch, hw=NYU_HW, n_sample=cfg.data.n_sample, seed=1)
    x = torch.from_numpy(np.stack([ds[i]["rgbd"] for i in range(args.batch)])).cuda()

    modules = module_times_ms(model, x, args.reps)
    kinds, top = kernel_kinds_ms(model, x, args.reps)
    print(f"nyu_eval forward, batch {args.batch}, {NYU_HW[0]}x{NYU_HW[1]}, float32 (TF32 off) on {card}")
    print("device ms per forward by module (CUDA events, median of reps):")
    for name, ms in modules.items():
        print(f"  {name:34s} {ms:9.3f}  {100 * ms / modules['forward']:5.1f}%")
    traced = sum(kinds.values())
    print(f"device ms per forward by kernel kind (torch.profiler, {traced:.3f} ms traced):")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:34s} {ms:9.3f}  {100 * ms / max(traced, 1e-9):5.1f}%")
    print("ten longest kernels (ms per forward):")
    for name, ms in top:
        print(f"  {ms:9.3f}  {name[:110]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "batch": args.batch, "hw": NYU_HW, "modules_ms": modules,
                       "kernel_kinds_ms": kinds, "top_kernels_ms": top}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
