"""Command-line interface (counterpart of cspn_tpu/cli.py:88-233,451-485).

    python -m cspn_tpu_torch eval  --preset nyu_eval --dataset synthetic --runs 5
    python -m cspn_tpu_torch infer --preset nyu_eval --dataset synthetic --buckets 1,8

Both run on `--device` (default cuda).  The NYU/KITTI file datasets, train,
export and the other subcommands wait for later slices (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _add_common_overrides(p: argparse.ArgumentParser):
    p.add_argument("--preset", default=None, help="named config preset")
    p.add_argument("--dataset", "--data-set", dest="dataset", default=None,
                   choices=["nyudepth", "kitti", "synthetic"])
    p.add_argument("--n-sample", type=int, default=None)
    p.add_argument("--batch-size-eval", type=int, default=None)
    p.add_argument("--model", default=None, help="resnet18|34|50|101|152")
    p.add_argument("--no-cspn", action="store_true", help="baseline model")
    p.add_argument("--cspn-step", type=int, default=None)
    p.add_argument("--cspn-norm-type", default=None, choices=["8sum", "8sum_abs"])
    p.add_argument("--cspn-backend", default=None, choices=["auto", "kernel", "reference"])
    p.add_argument("--best-model-dir", default=None,
                   help="directory of <checkpoint>.pt (a torch.save state dict)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _build_config(args):
    from cspn_tpu_torch.config import PRESETS, RunConfig

    cfg = PRESETS[args.preset] if args.preset else RunConfig()
    model = dataclasses.replace(cfg.model)
    data = dataclasses.replace(cfg.data)
    for src, obj, dst in [
        ("dataset", data, "dataset"),
        ("n_sample", data, "n_sample"),
        ("batch_size_eval", data, "batch_size_eval"),
        ("model", model, "arch"),
        ("cspn_step", model, "cspn_steps"),
        ("cspn_norm_type", model, "cspn_norm_type"),
        ("cspn_backend", model, "cspn_backend"),
    ]:
        v = getattr(args, src, None)
        if v is not None:
            setattr(obj, dst, v)
    if args.no_cspn:
        model.use_cspn = False
    cfg = dataclasses.replace(cfg, model=model, data=data)
    if args.best_model_dir:
        cfg = dataclasses.replace(cfg, best_model_dir=args.best_model_dir)
    return cfg


def cmd_eval(args):
    from cspn_tpu_torch.train.evaluate import run_eval

    return run_eval(_build_config(args), runs=args.runs, max_batches=args.max_batches,
                    device=args.device)


def cmd_infer(args):
    """Stream the val split through DepthServer.predict in groups of the top
    bucket; optionally save the predictions as one .npy array."""
    import numpy as np
    import torch

    from cspn_tpu_torch.serving import load_server
    from cspn_tpu_torch.train.factory import build_dataset

    cfg = _build_config(args)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    srv = load_server(cfg, buckets=buckets, device=args.device)
    ds = build_dataset(cfg, "val", seed=args.seed)
    h, w = ds[0]["rgbd"].shape[:2]
    srv.warmup(h, w)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    preds = []
    t0 = time.perf_counter()
    for start in range(0, n, buckets[-1]):
        stop = min(start + buckets[-1], n)
        preds.append(srv.predict(np.stack([ds[i]["rgbd"] for i in range(start, stop)])))
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.perf_counter() - t0
    preds = np.concatenate(preds)
    if args.out:
        np.save(args.out, preds)
    print(f"==> served {srv.served['float32']} frames of {h}x{w} on {srv.device} in "
          f"{dt:.3f} s" + (f", wrote {args.out}" if args.out else ""))
    return preds


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cspn_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_eval = sub.add_parser("eval", help="evaluate best_model on the val set")
    _add_common_overrides(p_eval)
    p_eval.add_argument("--runs", type=int, default=5,
                        help="sparse-resample eval runs to average (README protocol)")
    p_eval.add_argument("--max-batches", type=int, default=None)
    p_eval.set_defaults(fn=cmd_eval)

    p_inf = sub.add_parser("infer", help="batch inference via the bucketed serving front-end")
    _add_common_overrides(p_inf)
    p_inf.add_argument("--buckets", default="1,8,32,128",
                       help="comma-separated batch buckets")
    p_inf.add_argument("--max-frames", type=int, default=None)
    p_inf.add_argument("--seed", type=int, default=0)
    p_inf.add_argument("--out", default=None, help="save predictions to this .npy")
    p_inf.set_defaults(fn=cmd_infer)

    args = parser.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
