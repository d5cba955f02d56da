"""nyu_train step throughput on the card (counterpart of
scripts/train_bench.py).

The train step as the Trainer runs it (train/loop.py:make_train_step:
forward in train-mode BN, masked L1, backward through the CUDA CSPN and
depth-to-space kernels, SGD-Nesterov with weight decay, train/state.py)
on the ResNet-50 CSPN-UNet at 228x304, seed-0 weights, one fixed batch
of seeded random frames.  The steps run eagerly, as the Trainer runs
them: one first step, one warm chain, then `trials` chains of `chain`
steps, each between one pair of CUDA events (one sync at its end,
scripts/train_bench.py:73-86); the median over the trials of a chain's
time a step.

Prints one JSON line (`nyu_train_frames_per_s`, with `step_ms`) and writes
it, with the card, to result/torch_h100/train_bench.json.

    python -m cspn_tpu_torch.timing.train_bench [--batch 16] [--chain 16]
        [--trials 5] [--dtype bfloat16] [--arch resnet50] [--height 228]
        [--width 304] [--loss l1] [--momentum-dtype bfloat16]
        [--device cuda|cpu] [--out result/torch_h100/train_bench.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from cspn_tpu_torch import set_conv_policy
from cspn_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
from cspn_tpu_torch.experiments import device_arg, platform_fields, write_json
from cspn_tpu_torch.timing import default_out, log, sync

# the JAX script's line's keys (timing/__init__.py:missing_keys)
JAX_KEYS = dict.fromkeys(("metric", "value", "unit", "step_ms", "batch", "dtype", "arch"))


def make_step(args, device):
    """(train_step, rgbd, depth): the Trainer's step on the configured model
    and optimizer, and the seed-0 batch it is timed on."""
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer

    cfg = RunConfig(model=ModelConfig(arch=args.arch, dtype=args.dtype),
                    optim=OptimConfig(loss=args.loss, momentum_dtype=args.momentum_dtype))
    model = build_model(cfg, train=True, device=device)
    o = cfg.optim
    optimizer = make_optimizer(model.parameters(), o.lr, o.momentum, o.weight_decay, o.nesterov,
                               o.dampening, o.momentum_dtype)
    rng = np.random.default_rng(0)
    b, h, w = args.batch, args.height, args.width
    rgbd = torch.from_numpy(rng.standard_normal((b, h, w, 4)).astype(np.float32)).to(device)
    depth = torch.from_numpy(
        (np.abs(rng.standard_normal((b, h, w))) + 0.1).astype(np.float32)).to(device)
    return make_train_step(model, optimizer, o.loss), rgbd, depth


def chain_seconds(step, n: int, device, *inputs) -> float:
    """Seconds a step over `n` eager steps: CUDA events around the chain on
    the card (the host clock and a sync on the CPU)."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            step(*inputs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        loss, _ = step(*inputs)
    float(loss)
    return (time.perf_counter() - t0) / n


def run(args) -> dict:
    dev = device_arg(args)
    set_conv_policy(dev)
    t0 = time.perf_counter()
    step, rgbd, depth = make_step(args, dev)
    loss, _ = step(rgbd, depth)
    float(loss)
    log(f"train_bench: build + first step {time.perf_counter() - t0:.1f} s")
    chain_seconds(step, args.chain, dev, rgbd, depth)  # warm: one full chain
    times = [chain_seconds(step, args.chain, dev, rgbd, depth) for _ in range(args.trials)]
    sync(dev)
    sec = statistics.median(times)
    log(f"train_bench: per-step times (ms): {sorted(round(t * 1e3, 2) for t in times)}")
    return {
        "metric": "nyu_train_frames_per_s",
        "value": round(args.batch / sec, 1),
        "unit": "frames/s",
        "step_ms": round(sec * 1e3, 2),
        "batch": args.batch,
        "dtype": args.dtype,
        "arch": args.arch,
        **platform_fields(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.timing.train_bench",
                                 description="nyu_train step throughput")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--chain", type=int, default=16)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--arch", default="resnet50")
    ap.add_argument("--height", type=int, default=228)
    ap.add_argument("--width", type=int, default=304)
    ap.add_argument("--loss", default="l1")
    ap.add_argument("--momentum-dtype", default=None, choices=["bfloat16"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("train_bench"))
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rec = run(args)
    write_json(args.out, rec)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
