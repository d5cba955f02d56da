"""Stereo forward throughput on the card (counterpart of
scripts/stereo_bench.py; BASELINE config 5).

PSMNetCSPN (train/stereo_loop.py:build_stereo_model, seed-0 weights, eval
mode) at the PSMNet crop protocol: b4, 256x512, max_disp 192 (a 48x64x128
quarter-resolution cost volume), features 32, with the 24-step 3D CSPN
refinement on the hand-written kernels and without it (`use_cspn`), so
that the refinement's cost is explicit; float32 and bf16.

Forwards are chained, each disparity fed back into the next left image
(`left + disp[..., None] * 1e-9`, scripts/stereo_bench.py:50-53), and the
time a forward is the two-point slope between chains of `reps_lo` and
`reps_hi` forwards, the median of `trials` (timing/__init__.py:
slope_seconds): each chain one captured CUDA graph where the capture
succeeds (`"timing": "graph"`), else eager chains between CUDA events
(`"timing": "eager"`); the 3D CSPN stays the kernels' either way.

Prints one JSON line a row and writes them to
result/torch_h100/stereo_bench.jsonl.

    python -m cspn_tpu_torch.timing.stereo_bench [--dtype float32|bfloat16]
        [--device cuda|cpu] [--out result/torch_h100/stereo_bench.jsonl]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cspn_tpu_torch import resolve_device, set_conv_policy
from cspn_tpu_torch.experiments import device_arg, platform_fields
from cspn_tpu_torch.timing import default_out, log, slope_seconds, write_jsonl

REPS_LO, REPS_HI, TRIALS = 2, 10, 5
DTYPES = ("float32", "bfloat16")
# the JAX script's row keys (timing/__init__.py:missing_keys)
JAX_KEYS = dict.fromkeys(("model", "shape", "dtype", "cspn_steps", "ms_per_batch",
                          "frames_per_s"))


def bench(use_cspn: bool, batch: int = 4, h: int = 256, w: int = 512, max_disp: int = 192,
          steps: int = 24, dtype: str = "float32", features: int = 32, device=None,
          reps: tuple[int, int] = (REPS_LO, REPS_HI), trials: int = TRIALS) -> dict:
    """One row: the model's time a forward at the configuration."""
    from cspn_tpu_torch.train.stereo_loop import StereoConfig, build_stereo_model

    dev = resolve_device(device)
    cfg = StereoConfig(max_disp=max_disp, features=features, cspn_steps=steps,
                       use_cspn=use_cspn, dtype=dtype)
    t0 = time.perf_counter()
    model = build_stereo_model(cfg, train=False, device=dev)
    rng = np.random.default_rng()
    with torch.inference_mode():
        left = torch.from_numpy(rng.standard_normal((batch, h, w, 3)).astype(np.float32)).to(dev)
        right = torch.from_numpy(rng.standard_normal((batch, h, w, 3)).astype(np.float32)).to(dev)
        log(f"  init {time.perf_counter() - t0:.1f} s")

        def chain(n):
            def run():
                xi = left
                for _ in range(n):
                    xi = xi + model(xi, right)[..., None] * 1e-9
                return xi
            return run

        t0 = time.perf_counter()
        t, timing = slope_seconds(chain, left, rng, *reps, trials)
        log(f"  compile + warm + {trials} trials {time.perf_counter() - t0:.1f} s")
    return {
        "model": "PSMNetCSPN" if use_cspn else "PSMNet (no CSPN)",
        "shape": f"{batch}x{h}x{w}, D={max_disp}",
        "dtype": dtype,
        "cspn_steps": steps if use_cspn else 0,
        "ms_per_batch": round(t * 1e3, 2),
        "frames_per_s": round(batch / t, 1),
        "timing": timing,
        **platform_fields(dev),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.timing.stereo_bench",
                                 description="PSMNet forward throughput with and without the "
                                             "3D CSPN")
    ap.add_argument("--dtype", default=None, choices=DTYPES,
                    help="bench one dtype only (default: both)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("stereo_bench", lines=True))
    return ap


def main(argv=None, **config) -> list[dict]:
    """Every row (both dtypes unless --dtype, with and without the CSPN);
    `config` overrides bench()'s keyword arguments (reps, trials, sizes)."""
    args = build_parser().parse_args(argv)
    dev = device_arg(args)
    set_conv_policy(dev)
    rows = []
    for dtype in [args.dtype] if args.dtype else DTYPES:
        for use_cspn in (True, False):
            rows.append(bench(use_cspn, dtype=dtype, device=dev, **config))
            write_jsonl(args.out, rows)
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
