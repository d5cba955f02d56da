"""Command-line interface (counterpart of cspn_tpu/cli.py:18-233,451-485).

    python -m cspn_tpu_torch train --preset nyu_train --dataset synthetic --crop-hw 228,304
    python -m cspn_tpu_torch eval  --preset nyu_eval --dataset synthetic --runs 5
    python -m cspn_tpu_torch infer --preset nyu_eval --dataset synthetic --buckets 1,8
    python -m cspn_tpu_torch train-stereo --max-disp 192 --features 32 --prop-step 24 \
        --batch-size 4 --height 256 --width 512 [--train-list scene_flow.csv]
    python -m cspn_tpu_torch eval-stereo ... [--checkpoint best_model] [--dump-images]

All run on `--device` (default cuda).  The stereo subcommands train on the
synthetic stereo pairs unless --train-list names a Scene Flow manifest.
The NYU/KITTI file datasets, export
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


def _build_stereo(args):
    """Shared stereo config and loaders for train-stereo / eval-stereo."""
    from cspn_tpu_torch.data import DataLoader, SceneFlowStereoDataset, SyntheticStereoDataset
    from cspn_tpu_torch.train.stereo_loop import StereoConfig

    cfg = StereoConfig(
        max_disp=args.max_disp,
        features=args.features,
        cspn_steps=args.prop_step,
        use_cspn=not args.no_cspn,
        dtype=args.stereo_dtype or "float32",
        lr=args.lr,
        num_epochs=args.num_epoch,
        batch_size=args.batch_size,
        save_dir=args.save_dir,
    )
    if args.train_list:
        crop = (args.height, args.width)
        train_ds = SceneFlowStereoDataset(args.train_list, root_dir=args.root_dir, split="train",
                                          crop_hw=crop)
        val_ds = SceneFlowStereoDataset(args.eval_list or args.train_list, root_dir=args.root_dir,
                                        split="val", crop_hw=crop, seed=0)
    else:
        train_ds = SyntheticStereoDataset(length=args.train_size, hw=(args.height, args.width),
                                          max_disp=cfg.max_disp, seed=0)
        val_ds = SyntheticStereoDataset(length=max(args.train_size // 4, 2),
                                        hw=(args.height, args.width), max_disp=cfg.max_disp, seed=1)
    train_loader = DataLoader(train_ds, cfg.batch_size, shuffle=True, drop_last=True)
    val_loader = DataLoader(val_ds, cfg.batch_size)
    return cfg, train_loader, val_loader


def cmd_train_stereo(args):
    """Train the PSMNet + 3D-CSPN stereo model on Scene Flow manifests
    (--train-list/--eval-list CSVs with left,right,disp columns; disparity
    as PFM) or on the synthetic stereo pairs."""
    from cspn_tpu_torch.train.stereo_loop import StereoTrainer

    cfg, train_loader, val_loader = _build_stereo(args)
    return StereoTrainer(cfg, train_loader, val_loader, device=args.device).fit()


def cmd_eval_stereo(args):
    """Evaluate the stereo model: EPE / >3px / D1 on the val set, optional
    uint16 disparity*256 PNG dumps."""
    from cspn_tpu_torch.train.stereo_loop import StereoTrainer

    cfg, _, val_loader = _build_stereo(args)
    trainer = StereoTrainer(cfg, val_loader, val_loader, device=args.device)
    return trainer.run_eval(checkpoint=args.checkpoint, dump_images=args.dump_images)


def _add_stereo_args(p: argparse.ArgumentParser):
    p.add_argument("--max-disp", type=int, default=64)
    p.add_argument("--features", type=int, default=16)
    p.add_argument("--prop-step", type=int, default=12)
    p.add_argument("--no-cspn", action="store_true")
    p.add_argument("--dtype", dest="stereo_dtype", default=None, choices=["float32", "bfloat16"],
                   help="only float32 is ported (bfloat16 raises)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num-epoch", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--train-size", type=int, default=32)
    p.add_argument("--train-list", default=None,
                   help="Scene Flow CSV manifest (left,right,disp columns)")
    p.add_argument("--eval-list", default=None)
    p.add_argument("--root-dir", default=".")
    p.add_argument("--save-dir", default="result/stereo_cspn")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


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

    p_st = sub.add_parser("train-stereo", help="train the PSMNet + 3D-CSPN stereo model")
    _add_stereo_args(p_st)
    p_st.set_defaults(fn=cmd_train_stereo)

    p_se = sub.add_parser("eval-stereo",
                          help="evaluate the stereo model (EPE / >3px / D1, disparity dumps)")
    _add_stereo_args(p_se)
    p_se.add_argument("--checkpoint", default="best_model")
    p_se.add_argument("--dump-images", action="store_true",
                      help="write %%05d_{disp,gt}.png (uint16 disp*256)")
    p_se.set_defaults(fn=cmd_eval_stereo)

    args = parser.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
