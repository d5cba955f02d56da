"""Stereo train-step throughput on the card (counterpart of
scripts/stereo_train_bench.py).

The stereo train step (train/stereo_loop.py:make_stereo_train_step:
forward in train-mode BN, masked smooth-L1, backward through the 3D CSPN
kernels, SGD with momentum 0.9, weight decay 1e-4, no Nesterov) on
PSMNetCSPN (build_stereo_model, seed 0) at the PSMNet protocol: b4,
256x512, max_disp 192, features 32, 24 CSPN steps; float32 and bf16.

Steps run eagerly, as StereoTrainer runs them, each on the left image
perturbed as `left * (1 + seed + 1e-5 * i)` (scripts/stereo_train_bench.py
:61-70): two warm chains, then `trials` chains of `chain` steps, each
between one pair of CUDA events; the median over the trials of a chain's
time a step.

Prints one JSON line a dtype and writes them to
result/torch_h100/stereo_train_bench.jsonl.

    python -m cspn_tpu_torch.timing.stereo_train_bench [--dtype float32|bfloat16]
        [--device cuda|cpu] [--out result/torch_h100/stereo_train_bench.jsonl]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from cspn_tpu_torch import resolve_device, set_conv_policy
from cspn_tpu_torch.experiments import device_arg, platform_fields
from cspn_tpu_torch.timing import default_out, log, write_jsonl
from cspn_tpu_torch.timing.stereo_bench import DTYPES
from cspn_tpu_torch.timing.train_bench import chain_seconds

CHAIN, TRIALS = 8, 5
# the JAX script's row keys (timing/__init__.py:missing_keys)
JAX_KEYS = dict.fromkeys(("metric", "dtype", "shape", "ms_per_step", "frames_per_s"))


def bench(dtype: str, batch: int = 4, h: int = 256, w: int = 512, max_disp: int = 192,
          steps: int = 24, features: int = 32, device=None, chain: int = CHAIN,
          trials: int = TRIALS) -> dict:
    """One row: the train step's time at the configuration."""
    from cspn_tpu_torch.train.state import make_optimizer
    from cspn_tpu_torch.train.stereo_loop import (StereoConfig, build_stereo_model,
                                                  make_stereo_train_step)

    dev = resolve_device(device)
    cfg = StereoConfig(max_disp=max_disp, features=features, cspn_steps=steps, dtype=dtype,
                       batch_size=batch)
    t0 = time.perf_counter()
    model = build_stereo_model(cfg, train=True, device=dev)
    optimizer = make_optimizer(model.parameters(), cfg.lr, momentum=0.9, weight_decay=1e-4,
                               nesterov=False)
    step = make_stereo_train_step(model, optimizer, float(max_disp))
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.standard_normal((batch, h, w, 3)).astype(np.float32)).to(dev)
    right = torch.from_numpy(rng.standard_normal((batch, h, w, 3)).astype(np.float32)).to(dev)
    disp = torch.from_numpy(
        rng.uniform(0, max_disp - 1, (batch, h, w)).astype(np.float32)).to(dev)
    log(f"  init {time.perf_counter() - t0:.1f} s")

    class Perturbed:
        """The step on `left * (1 + seed + 1e-5 * i)` at its i-th call of a chain."""

        def __init__(self, seed: float):
            self.seed, self.i = seed, 0

        def __call__(self):
            out = step(left * (1.0 + self.seed + 1e-5 * self.i), right, disp)
            self.i += 1
            return out

    t0 = time.perf_counter()
    chain_seconds(Perturbed(1e-6), chain, dev)
    chain_seconds(Perturbed(2e-6), chain, dev)  # a second warm chain
    log(f"  compile + warm {time.perf_counter() - t0:.1f} s")
    times = [chain_seconds(Perturbed(float(np.random.default_rng(t).uniform(1e-6, 1e-5))),
                           chain, dev) for t in range(trials)]
    ms = statistics.median(times) * 1e3
    return {
        "metric": "stereo_train_step",
        "dtype": dtype,
        "shape": f"{batch}x{h}x{w}, D={max_disp}, cspn_steps={steps}",
        "ms_per_step": round(ms, 2),
        "frames_per_s": round(batch / ms * 1e3, 1),
        **platform_fields(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.timing.stereo_train_bench",
                                 description="stereo train-step throughput")
    ap.add_argument("--dtype", default=None, choices=DTYPES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("stereo_train_bench", lines=True))
    return ap


def main(argv=None, **config) -> list[dict]:
    """A row a dtype (both unless --dtype); `config` overrides bench()'s
    keyword arguments (chain, trials, sizes)."""
    args = build_parser().parse_args(argv)
    dev = device_arg(args)
    set_conv_policy(dev)
    rows = []
    for dtype in [args.dtype] if args.dtype else DTYPES:
        rows.append(bench(dtype, device=dev, **config))
        write_jsonl(args.out, rows)
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
