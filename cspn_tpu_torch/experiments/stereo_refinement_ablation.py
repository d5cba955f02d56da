"""Stereo CSPN-refinement ablation on the port (counterpart of
scripts/stereo_refinement_ablation.py): does the 3D CSPN improve EPE / D1?

The reference's staged protocol (a pretrained PSMNet loaded by
--loadmodel, --stereoType=cspn on top), per data seed:
  1. a shared PSMNet base WITHOUT refinement trains `--pretrain-epochs`;
  2. arm A (no_cspn) continues the base for `--finetune-epochs` more
     (`base.fit(pretrain + finetune)`); under `--freeze-base` it is the base
     itself, validated (`base.validate(pretrain)`);
  3. arm B (cspn) is a 3D-CSPN model that takes the base's parameters AND
     BN buffers as they were at the end of pretraining (every tensor but
     the new `guidance3d_head`; train/state.py:partial_restore) and trains
     `--finetune-epochs` (`fit(finetune)`); under `--freeze-base` only its
     zero-initialized guidance head trains (`train_only`,
     `guidance_zero_init`: the refinement starts as an identity).
Each arm reports its LAST epoch's val metrics (what `fit` returns); the
paired per-seed deltas take the population std (ddof=0), as the JAX
script's.  Every trainer inits from seed 0 (the JAX one from PRNGKey(0));
the seed picks the data.  Arm A's SGD updates the base's tensors in place,
so the base's state is cloned before arm A trains.  Checkpoints go to a
temporary directory that is removed after each seed.

    python -m cspn_tpu_torch.experiments.stereo_refinement_ablation \\
        [--pretrain-epochs 8] [--finetune-epochs 8] [--seeds 1] \\
        [--freeze-base] [--device cuda|cpu] [--out result/torch_h100/stereo_refinement.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import numpy as np

from cspn_tpu_torch.data import DataLoader, SyntheticStereoDataset
from cspn_tpu_torch.experiments import device_arg, platform_fields, write_json

METRICS = ("EPE", "3px", "D1")
DEFAULT_OUT = "result/torch_h100/stereo_refinement.json"
HEAD = "guidance3d_head"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m cspn_tpu_torch.experiments.stereo_refinement_ablation",
        description="fine-tune PSMNet +- 3D-CSPN refinement from a shared base per seed")
    ap.add_argument("--pretrain-epochs", type=int, default=8)
    ap.add_argument("--finetune-epochs", type=int, default=8)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--max-disp", type=int, default=32)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--prop-step", type=int, default=12)
    ap.add_argument("--train-size", type=int, default=64)
    ap.add_argument("--style", default="edges", choices=["smooth", "edges"],
                    help="synthetic disparity style; 'edges' has the sharp depth "
                         "discontinuities CSPN refinement exploits")
    ap.add_argument("--seeds", type=int, default=1, help="independent data seeds")
    ap.add_argument("--freeze-base", action="store_true",
                    help="arm B trains ONLY the zero-initialized guidance3d_head on the frozen "
                         "pretrained base (parameters and running statistics pinned)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def make_trainer(args, use_cspn: bool, seed: int, save_dir: str, device):
    from cspn_tpu_torch.train.stereo_loop import StereoConfig, StereoTrainer

    frozen = bool(use_cspn and args.freeze_base)
    cfg = StereoConfig(
        max_disp=args.max_disp,
        features=args.features,
        cspn_steps=args.prop_step,
        use_cspn=use_cspn,
        num_epochs=args.pretrain_epochs,
        train_only=HEAD if frozen else None,
        # an identity start only for the frozen-base protocol; the default
        # protocol keeps the lecun init
        guidance_zero_init=frozen,
        batch_size=4,
        save_dir=save_dir,
    )
    train_ds = SyntheticStereoDataset(length=args.train_size, hw=(args.height, args.width),
                                      max_disp=cfg.max_disp, seed=100 * seed, style=args.style)
    val_ds = SyntheticStereoDataset(length=16, hw=(args.height, args.width),
                                    max_disp=cfg.max_disp, seed=100 * seed + 1, style=args.style)
    return StereoTrainer(cfg, DataLoader(train_ds, cfg.batch_size, shuffle=True, drop_last=True),
                         DataLoader(val_ds, cfg.batch_size), device=device, seed=0)


def restore_base(model, base_state: dict, verbose: bool = False) -> list[str]:
    """Copy the entries of `base_state` whose name and shape `model` has
    (train/state.py:partial_restore) and return their names."""
    from cspn_tpu_torch.train.state import partial_restore

    target = model.state_dict()
    copied = [k for k, v in base_state.items()
              if k in target and tuple(target[k].shape) == tuple(v.shape)]
    partial_restore(model, base_state, verbose=verbose)
    return copied


def run_seed(args, seed: int, device=None, save_root: str | None = None,
             observe=None) -> tuple[dict, dict]:
    """One seed's two arms: (no_cspn metrics, cspn metrics).  `observe(stage,
    trainer)`, when given, sees the base after pretraining ('pretrained')
    and after arm A ('arm_a'), and arm B's trainer just after the restore
    ('restored', with `trainer.restored` the copied names)."""
    root = tempfile.mkdtemp(prefix=f"stereo_ablation_s{seed}_", dir=save_root)
    try:
        base = make_trainer(args, False, seed, os.path.join(root, "base"), device)
        base.fit(args.pretrain_epochs)
        if observe:
            observe("pretrained", base)
        # the base as pretrained: arm A's steps update its tensors in place
        base_state = {k: v.detach().clone() for k, v in base.model.state_dict().items()}
        if args.freeze_base:
            a = base.validate(args.pretrain_epochs)
        else:
            a = base.fit(args.pretrain_epochs + args.finetune_epochs)
        if observe:
            observe("arm_a", base)
        cspn = make_trainer(args, True, seed, os.path.join(root, "cspn"), device)
        cspn.restored = restore_base(cspn.model, base_state, verbose=seed == 0)
        del base, base_state
        if observe:
            observe("restored", cspn)
        b = cspn.fit(args.finetune_epochs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return a, b


def record(args, per_seed: dict, n_seeds: int, device) -> dict:
    """The artifact, as the JAX script writes it, with the platform and card:
    means, paired deltas (no_cspn - cspn, ddof=0) and the per-seed metrics."""
    results = {arm: {k: round(sum(r[k] for r in rs) / len(rs), 4) for k in rs[0]}
               for arm, rs in per_seed.items()}
    paired = {}
    for k in METRICS:
        d = [per_seed["no_cspn"][i][k] - per_seed["cspn"][i][k] for i in range(n_seeds)]
        paired[k] = {"mean": round(float(np.mean(d)), 4), "std": round(float(np.std(d)), 4)}
    return {
        "what": "PSMNet stereo on the PyTorch port: fine-tune +-3D-CSPN cost-volume refinement "
                "from a shared pretrained base (reference staged protocol, "
                "cspn_paddle/README.md:104-151 --loadmodel + --stereoType)",
        **platform_fields(device),
        "config": {
            "style": args.style,
            "hw": [args.height, args.width],
            "max_disp": args.max_disp,
            "features": args.features,
            "cspn_steps": args.prop_step,
            "pretrain_epochs": args.pretrain_epochs,
            "finetune_epochs": args.finetune_epochs,
            "train_frames": args.train_size,
            "seeds": n_seeds,
            "freeze_base": args.freeze_base,
        },
        "paired_improvement": paired,
        "no_cspn": results["no_cspn"],
        "cspn": results["cspn"],
        "per_seed": {arm: [{k: round(v, 4) for k, v in r.items()} for r in rs]
                     for arm, rs in per_seed.items()},
        "epe_improvement": round(results["no_cspn"]["EPE"] - results["cspn"]["EPE"], 4),
        "d1_improvement": round(results["no_cspn"]["D1"] - results["cspn"]["D1"], 4),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = device_arg(args)
    per_seed = {"no_cspn": [], "cspn": []}
    rec = None
    for seed in range(args.seeds):
        a, b = run_seed(args, seed, device)
        per_seed["no_cspn"].append(a)
        per_seed["cspn"].append(b)
        print(f"seed {seed} no_cspn: {a}\nseed {seed} cspn: {b}", flush=True)
        rec = record(args, per_seed, seed + 1, device)
        write_json(args.out, rec)  # after every seed: a cut sweep keeps what it finished
        print(f"means over {rec['config']['seeds']} seed(s): no_cspn {rec['no_cspn']}, "
              f"cspn {rec['cspn']}", flush=True)
    if rec is not None:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
