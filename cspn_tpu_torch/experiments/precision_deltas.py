"""Metric deltas of the reduced-precision paths on a TRAINED checkpoint
(counterparts of scripts/bf16_io_eval.py and the metric half of
scripts/int8_bench.py).

The 5-run eval (train/evaluate.py:run_eval) re-seeds the sparse sampler by
run index, so run k of every variant sees the same sparse points and the
deltas are paired: mean and population std (ddof=0) of the per-run
differences.  Two sets of variants:

  - `f32_io` / `bf16_io`: the float32 model with the 2D CSPN's inputs as
    they are or rounded through bf16 (`cspn_io_dtype`); deltas bf16_io -
    f32_io;
  - `bfloat16`, `int8` (the last decoder block excluded), `int8_static`
    (with static activation scales) and `int8_all` (no exclusion): the
    serving dtypes; deltas of each int8 variant - bfloat16.

The checkpoint is the port's own (`<best-model-dir>/best_model.pt`, e.g.
from `python -m cspn_tpu_torch train --preset synthetic_smoke --save-dir D
--best-model-dir D`); the JAX package's Orbax checkpoints need JAX to read.

    python -m cspn_tpu_torch.experiments.precision_deltas --best-model-dir D \\
        [--preset synthetic_smoke] [--runs 5] [--device cuda|cpu] \\
        [--out result/torch_h100/precision_deltas.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from cspn_tpu_torch.config import PRESETS, RunConfig
from cspn_tpu_torch.experiments import device_arg, platform_fields, write_json

DEFAULT_OUT = "result/torch_h100/precision_deltas.json"
IO_VARIANTS = {"f32_io": None, "bf16_io": "bfloat16"}
# name: (dtype, quant_exclude, act_static)
DTYPE_VARIANTS = {
    "bfloat16": ("bfloat16", ("gud_up_proj_layer4",), False),
    "int8": ("int8", ("gud_up_proj_layer4",), False),
    "int8_static": ("int8", ("gud_up_proj_layer4",), True),
    "int8_all": ("int8", (), False),
}


def variant_configs(base: RunConfig) -> dict[str, RunConfig]:
    """Every variant's config, the I/O variants first."""
    def with_model(**kw):
        return dataclasses.replace(base, model=dataclasses.replace(base.model, **kw))

    cfgs = {name: with_model(cspn_io_dtype=io) for name, io in IO_VARIANTS.items()}
    for name, (dtype, excl, act_static) in DTYPE_VARIANTS.items():
        cfgs[name] = with_model(dtype=dtype, quant_exclude=excl, act_static=act_static)
    return cfgs


def paired(per_run: dict, variant: str, baseline: str, runs: int, digits: int) -> dict:
    """Per metric: mean and std (ddof=0) of variant - baseline, run by run."""
    out = {}
    for k in per_run[baseline][0]:
        d = [per_run[variant][i][k] - per_run[baseline][i][k] for i in range(runs)]
        out[k] = {"mean": round(float(np.mean(d)), digits), "std": round(float(np.std(d)), digits)}
    return out


def run_means(rs: list) -> dict:
    return {k: round(float(np.mean([r[k] for r in rs])), 5) for k in rs[0]}


def summarize(per_run: dict, runs: int) -> dict:
    """The record's metrics from each variant's per-run dicts."""
    means = {name: run_means(rs) for name, rs in per_run.items()}
    dtype_eval = {name: means[name] for name in DTYPE_VARIANTS}
    dtype_eval["paired_deltas_vs_bf16"] = {name: paired(per_run, name, "bfloat16", runs, 5)
                                           for name in DTYPE_VARIANTS if name != "bfloat16"}
    return {
        "bf16_io": {"means": {name: means[name] for name in IO_VARIANTS},
                    "paired_deltas_bf16io_vs_f32io": paired(per_run, "bf16_io", "f32_io", runs,
                                                            6)},
        "dtype_eval": dtype_eval,
        "rmse_delta": round(means["int8"]["RMSE"] - means["bfloat16"]["RMSE"], 5),
        "irmse_delta": round(means["int8"]["iRMSE"] - means["bfloat16"]["iRMSE"], 5),
    }


def run(cfg: RunConfig, runs: int = 5, device=None, eval_fn=None) -> dict:
    """Evaluate every variant of `cfg` `runs` times; returns the metrics
    (summarize's keys) and the per-run dicts under `per_run`."""
    if eval_fn is None:
        from cspn_tpu_torch.train.evaluate import run_eval as eval_fn
    per_run = {}
    for name, vcfg in variant_configs(cfg).items():
        per_run[name] = eval_fn(vcfg, runs=runs, device=device)["runs"]
        print(f"{name}: {run_means(per_run[name])}", flush=True)
    return {**summarize(per_run, runs), "per_run": per_run}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cspn_tpu_torch.experiments.precision_deltas",
        description="paired 5-run metric deltas of bf16 CSPN inputs, bf16 and int8 serving on "
                    "a trained checkpoint")
    ap.add_argument("--best-model-dir", required=True,
                    help="the directory of the port's best_model.pt to evaluate")
    ap.add_argument("--preset", default="synthetic_smoke")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = device_arg(args)
    ckpt = os.path.join(args.best_model_dir, "best_model.pt")
    if not os.path.isfile(ckpt):
        raise SystemExit(f"no {ckpt}: precision deltas need a trained checkpoint")
    cfg = dataclasses.replace(PRESETS[args.preset], best_model_dir=args.best_model_dir)
    result = run(cfg, runs=args.runs, device=device)
    rec = {
        "what": "metric deltas of the reduced-precision paths on a trained checkpoint of the "
                "PyTorch port: bf16-rounded 2D CSPN inputs against float32, and int8 serving "
                "(dynamic, static activation scales, no exclusion) against bf16; paired per "
                "run of the 5-run eval",
        **platform_fields(device),
        "preset": args.preset,
        "runs": args.runs,
        **result,
    }
    write_json(args.out, rec)
    print(json.dumps({k: rec[k] for k in ("rmse_delta", "irmse_delta")}), flush=True)
    return rec


if __name__ == "__main__":
    main()
