"""Depth-completion CSPN ablation on the port (counterpart of
scripts/completion_refinement_ablation.py): does the 2D CSPN post-process
improve completion metrics over the no-CSPN baseline when trained?

Every arm trains END-TO-END from scratch with the reference recipe
(SGD-Nesterov, lr .01, masked L1, plateau-on-MAE) on identical synthetic
'edges' frames, whose RGB shows where depth jumps but not by how much;
arms differ ONLY in the post-process:
    no_cspn   -- plain UNet baseline
    cspn      -- 24-step CSPN, norm '8sum'
    cspn_abs  -- 24-step CSPN, norm '8sum_abs'
Each arm reports its BEST epoch by val RMSE (the reference selects its
released model so); per-seed paired deltas against no_cspn, with the
sample std (ddof=1).  Every arm of every seed starts from the same init
(`Trainer(seed=0)`, as the JAX Trainer inits from PRNGKey(0)); the seed
picks the data: training frames from `SyntheticDepthDataset(seed=100*s)`,
val frames from `seed=100*s+1`, made once a seed and cached.  No
checkpoints are written; each arm's logs go to a temporary directory that
is removed afterwards.

Monocular variant: `--style edges_mono --n-sample 0` (RGB encodes depth,
no sparse anchors).  On the card the arms' CSPNs run the hand-written
kernels (cspn_backend 'auto'); `run_arm(backend="reference")` trains an
arm through the plain CSPN instead.

    python -m cspn_tpu_torch.experiments.completion_refinement_ablation \\
        [--seeds 5] [--seed-base 0] [--epochs 10] [--arch resnet18] \\
        [--style edges|edges_mono|smooth] [--n-sample N] [--small] \\
        [--device cuda|cpu] [--out result/torch_h100/completion_refinement.json]

A sweep cut short resumes with `--seed-base K --out part2.json`; the
parts merge with `python -m cspn_tpu_torch.experiments.merge_ablation_artifacts`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile

import numpy as np
import torch

from cspn_tpu_torch.config import DataConfig, ModelConfig, OptimConfig, RunConfig
from cspn_tpu_torch.data import DataLoader, SyntheticDepthDataset
from cspn_tpu_torch.experiments import device_arg, platform_fields, write_json

REPORT_KEYS = ("RMSE", "MAE", "ABS_REL", "DELTA1.02", "DELTA1.05", "DELTA1.10")

ARMS = {
    "no_cspn": dict(use_cspn=False),
    "cspn": dict(use_cspn=True, cspn_norm_type="8sum"),
    "cspn_abs": dict(use_cspn=True, cspn_norm_type="8sum_abs"),
}

DEFAULT_OUT = "result/torch_h100/completion_refinement.json"


def paired_deltas(per_seed: dict, keys=REPORT_KEYS) -> dict:
    """Per-seed paired improvements of each arm over no_cspn: positive =
    better (errors go down, DELTA thresholds go up); the sample std
    (ddof=1), with n."""
    paired = {}
    for arm, rs in per_seed.items():
        if arm == "no_cspn" or not rs:
            continue
        paired[arm] = {}
        for k in keys:
            sgn = -1.0 if k.startswith("DELTA") else 1.0
            d = [sgn * (per_seed["no_cspn"][i][k] - rs[i][k]) for i in range(len(rs))]
            std = float(np.std(d, ddof=1)) if len(d) > 1 else 0.0
            paired[arm][k] = {"mean": round(float(np.mean(d)), 4), "std": round(std, 4),
                              "n": len(d)}
    return paired


def arm_means(per_seed: dict) -> dict:
    return {arm: {k: round(sum(r[k] for r in rs) / len(rs), 4) for k in rs[0]}
            for arm, rs in per_seed.items() if rs}


class _Cached:
    """A deterministic dataset materialized once (a 228x304 sample is ~1.4 MB)."""

    def __init__(self, ds):
        self.samples = [ds[i] for i in range(len(ds))]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cspn_tpu_torch.experiments.completion_refinement_ablation",
        description="train UNet +- 2D CSPN from scratch per seed; paired deltas vs no_cspn")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--seed-base", type=int, default=0,
                    help="first seed index (resume a cut sweep; merge the parts with "
                         "merge_ablation_artifacts)")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--arch", default="resnet18", help="reference KITTI trunk")
    ap.add_argument("--height", type=int, default=228)
    ap.add_argument("--width", type=int, default=304)
    ap.add_argument("--prop-step", type=int, default=24)
    ap.add_argument("--n-sample", type=int, default=500,
                    help="0 = monocular (the nyu_mono preset)")
    ap.add_argument("--style", default="edges", choices=["smooth", "edges", "edges_mono"],
                    help="'edges' for completion (RGB does not encode absolute depth); "
                         "'edges_mono' for the monocular ablation")
    ap.add_argument("--train-size", type=int, default=96)
    ap.add_argument("--val-size", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--small", action="store_true", help="tiny geometry smoke config (CPU)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.small:
        args.height, args.width = 64, 96
        args.prop_step = 12
        args.train_size, args.val_size = 32, 16
        args.batch_size = 4
    return args


def arm_config(args, arm: str, save_dir: str, backend: str = "auto") -> RunConfig:
    return RunConfig(
        model=ModelConfig(arch=args.arch, cspn_steps=args.prop_step, cspn_backend=backend,
                          **ARMS[arm]),
        data=DataConfig(dataset="synthetic", n_sample=args.n_sample,
                        batch_size_train=args.batch_size),
        optim=OptimConfig(num_epochs=args.epochs),
        save_dir=save_dir,
        log_every=1000,
    )


def seed_data(args, seed: int) -> tuple[_Cached, _Cached]:
    """The seed's training and val frames, each made once."""
    def ds(length, s):
        return _Cached(SyntheticDepthDataset(length=length, hw=(args.height, args.width),
                                             n_sample=args.n_sample, seed=s, style=args.style))

    return ds(args.train_size, 100 * seed), ds(args.val_size, 100 * seed + 1)


def loaders(args, data) -> tuple[DataLoader, DataLoader]:
    train_ds, val_ds = data
    return (DataLoader(train_ds, args.batch_size, shuffle=True, drop_last=True),
            DataLoader(val_ds, min(args.batch_size, args.val_size)))


@dataclasses.dataclass
class ArmRun:
    best: dict  # REPORT_KEYS of the best epoch by val RMSE, rounded to 4 places
    history: list  # per epoch: {"train_loss": mean train-step loss, "val": REPORT_KEYS}


def run_arm(args, arm: str, seed: int, data=None, device=None, backend: str = "auto",
            epochs: int | None = None, save_root: str | None = None) -> ArmRun:
    """Train `arm` from the shared init on the seed's frames for `epochs`
    (default args.epochs), validating after each; the save dir is a
    temporary directory under `save_root` (default the system's), removed
    afterwards, into which only the Trainer's logs go."""
    from cspn_tpu_torch.train.loop import Trainer

    data = data if data is not None else seed_data(args, seed)
    save_dir = tempfile.mkdtemp(prefix=f"completion_ablation_{arm}_s{seed}_", dir=save_root)
    try:
        trainer = Trainer(arm_config(args, arm, save_dir, backend), *loaders(args, data),
                          device=device, seed=0)
        # ablation runs need no checkpoints (arms x seeds x epochs of them)
        trainer.ckpt.save_epoch = lambda *a, **k: None
        trainer.ckpt.save_best = lambda *a, **k: None
        losses = []
        step = trainer.train_step

        def recorded_step(rgbd, depth):
            loss, error = step(rgbd, depth)
            losses.append(loss)
            return loss, error

        trainer.train_step = recorded_step
        best, history = None, []
        for epoch in range(args.epochs if epochs is None else epochs):
            losses.clear()
            trainer.train_epoch(epoch)
            train_loss = float(torch.stack(losses).mean())
            val = trainer.validate(epoch)
            history.append({"train_loss": train_loss, "val": {k: val[k] for k in REPORT_KEYS}})
            if best is None or val["RMSE"] < best["RMSE"]:
                best = {k: val[k] for k in REPORT_KEYS}
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    return ArmRun({k: round(float(v), 4) for k, v in best.items()}, history)


def record(args, per_seed: dict, n_seeds: int, device) -> dict:
    """The artifact: the JAX script's keys, with the platform and card."""
    return {
        "what": "depth completion on the PyTorch port: train UNet +- 2D CSPN post-process "
                f"from scratch on synthetic '{args.style}' data, the CSPN arms through "
                "cspn_backend 'auto' (reference protocol train.py:286-289; core claim "
                "cspn_pytorch/README.md:73-79)",
        **platform_fields(device),
        "config": {
            "arch": args.arch,
            "hw": [args.height, args.width],
            "cspn_steps": args.prop_step,
            "n_sample": args.n_sample,
            "epochs": args.epochs,
            "train_frames": args.train_size,
            "val_frames": args.val_size,
            "batch_size": args.batch_size,
            "seeds": n_seeds,
            "style": args.style,
        },
        "paired_improvement_vs_no_cspn": paired_deltas(per_seed),
        "means": arm_means(per_seed),
        "per_seed": per_seed,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = device_arg(args)
    per_seed = {arm: [] for arm in ARMS}
    rec = None
    for seed in range(args.seed_base, args.seed_base + args.seeds):
        data = seed_data(args, seed)
        for arm in ARMS:
            r = run_arm(args, arm, seed, data=data, device=device).best
            per_seed[arm].append(r)
            print(f"seed {seed} {arm}: {r}", flush=True)
        rec = record(args, per_seed, seed - args.seed_base + 1, device)
        write_json(args.out, rec)  # after every seed: a cut sweep keeps what it finished
        print(f"means over {rec['config']['seeds']} seed(s): {rec['means']}", flush=True)
    if rec is not None:
        print(json.dumps({k: rec[k] for k in ("paired_improvement_vs_no_cspn", "means")}),
              flush=True)
    return rec


if __name__ == "__main__":
    main()
