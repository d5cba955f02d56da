"""Command-line interface (counterpart of cspn_tpu/cli.py:18-233,451-485).

    python -m cspn_tpu_torch train --preset nyu_train --dataset synthetic --crop-hw 228,304
    python -m cspn_tpu_torch eval  --preset nyu_eval --dataset synthetic --runs 5
    python -m cspn_tpu_torch infer --preset nyu_eval --dataset synthetic --buckets 1,8

All run on `--device` (default cuda).  The NYU/KITTI file datasets, export
and the other subcommands wait for later slices (ROADMAP.md Queue 1), as do
the train flags that raise: --dtype other than float32 (Queue 1 item 12),
--grad-reduce-dtype and a --mesh-* larger than 1 (items 8-9).
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
    p.add_argument("--crop-hw", default=None, type=lambda v: tuple(int(x) for x in v.split(",")),
                   help="H,W of the frames (e.g. 228,304, the NYU crop, for synthetic data)")
    p.add_argument("--batch-size-eval", type=int, default=None)
    p.add_argument("--model", default=None, help="resnet18|34|50|101|152")
    p.add_argument("--no-cspn", action="store_true", help="baseline model")
    p.add_argument("--cspn-step", type=int, default=None)
    p.add_argument("--cspn-norm-type", default=None, choices=["8sum", "8sum_abs"])
    p.add_argument("--cspn-backend", default=None, choices=["auto", "kernel", "reference"])
    p.add_argument("--best-model-dir", default=None,
                   help="directory of <checkpoint>.pt (a torch.save state dict)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _add_train_overrides(p: argparse.ArgumentParser):
    p.add_argument("--batch-size-train", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "int8"],
                   help="only float32 is ported (the others raise)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--weight-decay", dest="weight_decay", type=float, default=None)
    p.add_argument("--dampening", type=float, default=None,
                   help="SGD dampening (torch semantics; requires --no-nesterov)")
    p.add_argument("--nesterov", "-n", dest="nesterov", action="store_true",
                   default=None, help="enable Nesterov momentum (preset default)")
    p.add_argument("--no-nesterov", dest="nesterov", action="store_false",
                   help="plain momentum SGD")
    p.add_argument("--num-epoch", type=int, default=None)
    p.add_argument("--loss", default=None, choices=["l1", "berhu"])
    p.add_argument("--save-dir", default=None)
    p.add_argument("--resume", "-r", action="store_true",
                   help="continue from <save-dir>/best_model.pt (full train state)")
    p.add_argument("--pretrain-path", default=None,
                   help="torchvision-format .pth with pretrained encoder weights")
    p.add_argument("--momentum-dtype", dest="momentum_dtype", default=None,
                   choices=["bfloat16"],
                   help="store the SGD momentum in this dtype (update math stays f32)")
    p.add_argument("--grad-reduce-dtype", dest="grad_reduce_dtype", default=None,
                   choices=["bfloat16"], help="not ported (raises)")
    p.add_argument("--mesh-data", type=int, default=None, help="only 1 is ported")
    p.add_argument("--mesh-spatial", type=int, default=1, help="only 1 is ported")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run to this dir")


def _build_config(args):
    from cspn_tpu_torch.config import PRESETS, RunConfig

    cfg = PRESETS[args.preset] if args.preset else RunConfig()
    model = dataclasses.replace(cfg.model)
    data = dataclasses.replace(cfg.data)
    optim = dataclasses.replace(cfg.optim)
    for src, obj, dst in [
        ("dataset", data, "dataset"),
        ("n_sample", data, "n_sample"),
        ("crop_hw", data, "crop_hw"),
        ("batch_size_eval", data, "batch_size_eval"),
        ("batch_size_train", data, "batch_size_train"),
        ("model", model, "arch"),
        ("cspn_step", model, "cspn_steps"),
        ("cspn_norm_type", model, "cspn_norm_type"),
        ("cspn_backend", model, "cspn_backend"),
        ("dtype", model, "dtype"),
        ("lr", optim, "lr"),
        ("momentum", optim, "momentum"),
        ("weight_decay", optim, "weight_decay"),
        ("dampening", optim, "dampening"),
        ("nesterov", optim, "nesterov"),
        ("num_epoch", optim, "num_epochs"),
        ("loss", optim, "loss"),
        ("grad_reduce_dtype", optim, "grad_reduce_dtype"),
        ("momentum_dtype", optim, "momentum_dtype"),
    ]:
        v = getattr(args, src, None)
        if v is not None:
            setattr(obj, dst, v)
    if args.no_cspn:
        model.use_cspn = False
    cfg = dataclasses.replace(cfg, model=model, data=data, optim=optim)
    for src, dst in [("save_dir", "save_dir"), ("best_model_dir", "best_model_dir"),
                     ("pretrain_path", "pretrained_path"), ("mesh_data", "mesh_data"),
                     ("mesh_spatial", "mesh_spatial")]:
        v = getattr(args, src, None)
        if v is not None:
            cfg = dataclasses.replace(cfg, **{dst: v})
    if getattr(args, "resume", False):
        cfg = dataclasses.replace(cfg, resume=True)
    return cfg


def cmd_train(args):
    import contextlib

    from cspn_tpu_torch.train.factory import build_loaders
    from cspn_tpu_torch.train.loop import Trainer
    from cspn_tpu_torch.utils.profiling import trace

    cfg = _build_config(args)
    train_loader, val_loader = build_loaders(cfg)
    pretrained = None
    if cfg.pretrained_path:
        from cspn_tpu_torch.models.torch_import import load_torch_encoder_params

        pretrained = load_torch_encoder_params(cfg.pretrained_path)
    trainer = Trainer(cfg, train_loader, val_loader, pretrained_params=pretrained,
                      device=args.device)
    if cfg.resume:
        trainer.resume("best_model")
    with trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext():
        return trainer.fit()


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

    p_train = sub.add_parser("train", help="train (synthetic data; one device)")
    _add_common_overrides(p_train)
    _add_train_overrides(p_train)
    p_train.set_defaults(fn=cmd_train)

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
