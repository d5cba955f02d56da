"""Command-line interface (counterpart of cspn_tpu/cli.py:18-233,451-485).

    python -m cspn_tpu_torch train --preset nyu_train [--input-format img --train-list train.csv \
        --eval-list val.csv --root-dir DIR] [--num-workers N --worker-mode thread|process]
    python -m cspn_tpu_torch train --preset nyu_train --dataset synthetic --crop-hw 228,304
    python -m cspn_tpu_torch eval  --preset nyu_eval --runs 5 [--eval-list val.csv]
    python -m cspn_tpu_torch eval  ... [--dump-images] [--import-torch-checkpoint best_model.pth]
    python -m cspn_tpu_torch infer --preset nyu_eval --dataset synthetic --buckets 1,8,32 \
        [--int8-from 8] [--act-static] [--out-dir DIR] [--import-torch-checkpoint best_model.pth]
    python -m cspn_tpu_torch export --preset nyu_eval --out model.pt2 [--batch N] [--no-embed] \
        [--check] [--dtype bfloat16|int8 [--act-static]] [--import-torch-checkpoint best_model.pth]
    python -m cspn_tpu_torch train-stereo --max-disp 192 --features 32 --prop-step 24 \
        --batch-size 4 --height 256 --width 512 [--train-list scene_flow.csv]
    python -m cspn_tpu_torch eval-stereo ... [--checkpoint best_model] [--dump-images]
    python -m cspn_tpu_torch demo --dim-num 2 [--prop-step 24 --batch-size 3 --iter-num 20]
    torchrun --nproc-per-node N -m cspn_tpu_torch train --mesh-data N [--grad-reduce-dtype bfloat16] ...
    python -m cspn_tpu_torch bench-scaling --mode train|eval|stereo [--force-cpu-devices N]
    python -m cspn_tpu_torch bench [--device cuda]
    python -m cspn_tpu_torch make-manifest DATA_DIR OUT.csv [--pattern '**/*.h5'] [--relative-to DIR]

All run on `--device` (default cuda).  `train`, `eval`, `infer` and
`export` read the NYU and KITTI frames of the preset's manifests
(`--train-list`, `--eval-list` under `--root-dir`): `--input-format hdf5`
(one .h5 a frame, h5py) or `img` (two columns, rgb and depth images; PNGs
are decoded without PIL), augmented by the host library
(csrc/host_pipeline.cpp) in `--num-workers` loader workers, threads or
spawned processes (`--worker-mode`); `--dataset synthetic` trains on
procedural frames instead.  The stereo subcommands train on the
synthetic stereo pairs unless --train-list names a Scene Flow manifest.
`train` and `train-stereo` train data-parallel when a launcher (torchrun)
starts them as ranks of a process group (parallel/distributed.py): one
card a rank, `--mesh-data` x `--mesh-spatial` ranks (train/loop.py).
`--dtype bfloat16` computes the conv nets in bf16 on float32 parameters
(train, eval, infer, train-stereo, eval-stereo); `--dtype int8` serves
(eval, infer) the bf16 model with int8 convs, `--act-static` with static
activation scales calibrated at load.  `infer` serves through
`load_server`: bf16 below `--int8-from`, int8 from it up.  The 2D and
3D CSPNs run float32 states at every dtype.  `export` writes the eval
graph as one `torch.export` artifact (export.py); `--import-torch-checkpoint`
evaluates, serves or exports a whole model trained by the reference
(models/torch_import.py).  `bench` prints nyu_eval frames/s on the card
as one JSON line (bench.py: the ResNet-50 CSPN-UNet at 228x304, b128, on
the kernel, int8 and plain reference paths, each a captured CUDA graph).
`--cspn-io-dtype bfloat16` rounds the 2D CSPN's inputs through bf16;
`train --debug-nans` raises where a forward first gives a NaN
(utils/profiling.py:debug_nans).  --tf32 computes float32 convolutions in
TF32 (default off).
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
    p.add_argument("--train-list", default=None)
    p.add_argument("--eval-list", default=None)
    p.add_argument("--root-dir", default=None)
    p.add_argument("--n-sample", type=int, default=None)
    p.add_argument("--input-format", dest="input_format", default=None, choices=["hdf5", "img"],
                   help="hdf5: one-column manifest of .h5 frames; img: two-column manifest of "
                        "(rgb, depth) images")
    p.add_argument("--num-workers", dest="num_workers", type=int, default=None,
                   help="loader workers (reference train.py:117 workers=2)")
    p.add_argument("--worker-mode", dest="worker_mode", default=None,
                   choices=["thread", "process"],
                   help="loader worker model: threads, or spawned worker processes")
    p.add_argument("--crop-hw", default=None, type=lambda v: tuple(int(x) for x in v.split(",")),
                   help="H,W of the frames: the file datasets' centre crop (e.g. 352,1216), or "
                        "the synthetic frames' size (e.g. 228,304)")
    p.add_argument("--batch-size-eval", type=int, default=None)
    p.add_argument("--model", default=None, help="resnet18|34|50|101|152")
    p.add_argument("--no-cspn", action="store_true", help="baseline model")
    p.add_argument("--cspn-step", type=int, default=None)
    p.add_argument("--cspn-norm-type", default=None, choices=["8sum", "8sum_abs"])
    p.add_argument("--cspn-backend", default=None, choices=["auto", "kernel", "reference"])
    p.add_argument("--best-model-dir", default=None,
                   help="directory of <checkpoint>.pt (a torch.save state dict)")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "int8"],
                   help="compute dtype of the conv net: bf16 on float32 parameters; int8 "
                        "serves (eval, infer) the bf16 model with int8 convs")
    p.add_argument("--act-static", dest="act_static", action="store_true",
                   help="int8 serving: static activation scales calibrated at load (no "
                        "abs-max reduce per quantized conv and call)")
    p.add_argument("--cspn-io-dtype", dest="cspn_io_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="I/O dtype of the 2D CSPN's inputs (bfloat16: rounded through it; the "
                        "arithmetic stays float32)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError where a module's forward first gives a NaN, "
                        "and check the backward for NaNs (utils/profiling.py:debug_nans)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    _add_tf32(p)


def _add_tf32(p: argparse.ArgumentParser):
    p.add_argument("--tf32", action="store_true",
                   help="float32 convolutions and matmuls in TF32 on the card (default: IEEE "
                        "float32; cspn_tpu_torch.set_conv_policy)")


def _add_import(p: argparse.ArgumentParser):
    p.add_argument("--import-torch-checkpoint", default=None,
                   help="a whole model trained by the reference (best_model.pth), in place "
                        "of <best-model-dir>/best_model.pt")


def _add_train_overrides(p: argparse.ArgumentParser):
    p.add_argument("--batch-size-train", type=int, default=None)
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
                   choices=["bfloat16"],
                   help="data-parallel gradient reduce in this dtype, with per-replica BN "
                        "(default: float32 with sync-BN)")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel ranks (default: every rank of the process group)")
    p.add_argument("--mesh-spatial", type=int, default=1,
                   help="spatial axis of the mesh: replicates the step, as the JAX Trainer")
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
        ("train_list", data, "train_list"),
        ("eval_list", data, "eval_list"),
        ("root_dir", data, "root_dir"),
        ("n_sample", data, "n_sample"),
        ("input_format", data, "input_format"),
        ("num_workers", data, "num_workers"),
        ("worker_mode", data, "worker_mode"),
        ("crop_hw", data, "crop_hw"),
        ("batch_size_eval", data, "batch_size_eval"),
        ("batch_size_train", data, "batch_size_train"),
        ("model", model, "arch"),
        ("cspn_step", model, "cspn_steps"),
        ("cspn_norm_type", model, "cspn_norm_type"),
        ("cspn_backend", model, "cspn_backend"),
        ("dtype", model, "dtype"),
        ("cspn_io_dtype", model, "cspn_io_dtype"),
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
    if getattr(args, "act_static", False):
        model.act_static = True
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

    from cspn_tpu_torch.parallel.distributed import initialize_multihost
    from cspn_tpu_torch.train.factory import build_loaders
    from cspn_tpu_torch.train.loop import Trainer
    from cspn_tpu_torch.utils.profiling import trace

    if args.debug_nans:  # cspn_tpu/cli.py:161-164
        from cspn_tpu_torch.utils.profiling import debug_nans

        debug_nans(True)
    initialize_multihost()  # under torchrun: this rank's process group
    cfg = _build_config(args)
    train_loader, val_loader = build_loaders(cfg)
    pretrained = None
    if cfg.pretrained_path:
        from cspn_tpu_torch.models.torch_import import load_torch_encoder_params

        pretrained = load_torch_encoder_params(cfg.pretrained_path)
    trainer = Trainer(cfg, train_loader, val_loader, pretrained_params=pretrained,
                      device=args.device, tf32=args.tf32)
    if cfg.resume:
        trainer.resume("best_model")
    with trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext():
        return trainer.fit()


def cmd_eval(args):
    from cspn_tpu_torch.train.evaluate import run_eval

    return run_eval(_build_config(args), runs=args.runs, max_batches=args.max_batches,
                    device=args.device, tf32=args.tf32, dump_images=args.dump_images,
                    torch_checkpoint=args.import_torch_checkpoint)


def cmd_infer(args):
    """Stream the val split through DepthServer.predict in groups of the top
    bucket, write each prediction as %05d_pred.png into --out-dir (default
    <best_model_dir>/infer_result), and optionally all of them as one .npy
    array (--out)."""
    import os

    import numpy as np
    import torch

    from cspn_tpu_torch.serving import load_server
    from cspn_tpu_torch.train.factory import build_dataset
    from cspn_tpu_torch.utils.images import save_pred_image

    cfg = _build_config(args)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    srv = load_server(cfg, buckets=buckets, device=args.device, tf32=args.tf32,
                      int8_from=args.int8_from if args.int8_from > 0 else None,
                      torch_checkpoint=args.import_torch_checkpoint)
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
    out_dir = args.out_dir or os.path.join(cfg.best_model_dir, "infer_result")
    for i, pred in enumerate(preds):
        save_pred_image(cfg.data.dataset, out_dir, i, pred)
    if args.out:
        np.save(args.out, preds)
    print(f"==> served {srv.served} frames of {h}x{w} on {srv.device} in {dt:.3f} s, wrote "
          f"{len(preds)} predictions to {out_dir}" + (f" and {args.out}" if args.out else ""))
    return preds


def cmd_export(args):
    """Export the eval graph at the serving geometry (--height/--width,
    default the val split's) as one torch.export artifact (export.py), with
    the weights or, with --no-embed, without them; --check reloads it and
    prints max|err| against the eager model (cspn_tpu/cli.py:236-297).
    Exported on the card, the graph launches the hand-written CSPN and
    depth-to-space kernels."""
    import os

    import numpy as np
    import torch

    from cspn_tpu_torch import resolve_device, set_conv_policy
    from cspn_tpu_torch.export import (export_serving, load_artifact, op_counts, save_artifact,
                                       serving_weights)
    from cspn_tpu_torch.train.evaluate import load_eval_state

    cfg = _build_config(args)
    device = resolve_device(args.device)
    set_conv_policy(device, tf32=args.tf32)
    model = load_eval_state(cfg, device=device, torch_checkpoint=args.import_torch_checkpoint)
    if args.height and args.width:
        h, w = args.height, args.width
    elif cfg.data.crop_hw:  # every dataset's output geometry where set
        h, w = cfg.data.crop_hw
    else:  # the val split's first frame (cspn_tpu/cli.py:256-260)
        from cspn_tpu_torch.train.factory import build_dataset

        h, w = build_dataset(cfg, "val", seed=0)[0]["rgbd"].shape[:2]
    t0 = time.perf_counter()
    program = export_serving(model, h, w, batch=args.batch, embed=not args.no_embed)
    t1 = time.perf_counter()
    weights = serving_weights(model) if args.no_embed else None
    meta = {"arch": cfg.model.arch, "dtype": cfg.model.dtype, "cspn_steps": cfg.model.cspn_steps,
            "height": h, "width": w, "batch": args.batch, "tf32": args.tf32}
    save_artifact(program, args.out, meta, weights)
    print(f"==> wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, {device.type}, "
          f"batch {'b (symbolic)' if args.batch is None else args.batch}, custom ops "
          f"{op_counts(program)}): exported in {t1 - t0:.1f} s, saved in "
          f"{time.perf_counter() - t1:.1f} s")
    if args.check:
        art = load_artifact(args.out)
        n = args.batch or 2
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, h, w, 4))
                             .astype(np.float32)).to(device)
        with torch.no_grad():
            want = model(x)
        got = art.call(x) if weights is None else art.call(weights, x)
        err = float((want - got).abs().max())
        print(f"==> roundtrip check max|err| = {err:.3e}")
        return err
    return None


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
    from cspn_tpu_torch.parallel.distributed import initialize_multihost
    from cspn_tpu_torch.train.stereo_loop import StereoTrainer

    initialize_multihost()  # under torchrun: this rank's process group
    cfg, train_loader, val_loader = _build_stereo(args)
    return StereoTrainer(cfg, train_loader, val_loader, device=args.device, tf32=args.tf32).fit()


def cmd_eval_stereo(args):
    """Evaluate the stereo model: EPE / >3px / D1 on the val set, optional
    uint16 disparity*256 PNG dumps."""
    from cspn_tpu_torch.train.stereo_loop import StereoTrainer

    cfg, _, val_loader = _build_stereo(args)
    trainer = StereoTrainer(cfg, val_loader, val_loader, device=args.device, tf32=args.tf32)
    return trainer.run_eval(checkpoint=args.checkpoint, dump_images=args.dump_images)


def cmd_demo(args):
    """Op-level demo mirroring cspn_paddle/demo.py (and cspn_tpu's `demo`):
    random guidance and features through `prop_step` cspn_nd steps, Adam on
    both, the loss printed per iteration.  On the card, 2D runs the paddle
    2D kernel and 3D the 3D kernels.  Returns the losses."""
    import numpy as np
    import torch

    from cspn_tpu_torch.ops.cspn import cspn_nd

    dim, c, k, steps = args.dim_num, args.feat_chan, args.prop_kernel, args.prop_step
    map_shape = tuple([48, 64, 128][3 - dim :])
    n_gates = k**dim - 1
    rng = np.random.default_rng(0)
    guide = rng.random((args.batch_size, *map_shape, c * n_gates)).astype(np.float32)
    feat = rng.random((args.batch_size, *map_shape, c)).astype(np.float32)
    params = [torch.tensor(a, device=args.device, requires_grad=True) for a in (guide, feat)]
    opt = torch.optim.Adam(params, lr=1e-3)  # optax.adam(1e-3)'s defaults and update
    losses = []
    for i in range(args.iter_num):
        opt.zero_grad(set_to_none=True)
        loss = cspn_nd(*params, kernel_size=k, steps=steps).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        print(f"iter={i:02d}  out={losses[-1]:.4f}", flush=True)
    return losses


def cmd_make_manifest(args):
    from cspn_tpu_torch.data.manifest import make_manifest

    n = make_manifest(args.data_dir, args.out, pattern=args.pattern, relative_to=args.relative_to)
    print(f"wrote {n} rows to {args.out}")
    return n


def cmd_bench_scaling(args):
    """Throughput against the data axis' size (utils/scaling.py); one JSON
    line a mesh size.  --force-cpu-devices N: N gloo ranks on the CPU (the
    mechanics, not scaling), as the JAX package's virtual CPU mesh."""
    import json

    from cspn_tpu_torch.utils.scaling import run_scaling_bench

    cpu = args.force_cpu_devices > 0
    records = run_scaling_bench(
        arch=args.model, hw=(args.height, args.width), batch_per_device=args.batch_per_device,
        cspn_steps=args.cspn_step, mode=args.mode, spatial=args.mesh_spatial_bench,
        max_devices=args.force_cpu_devices if cpu else None, device="cpu" if cpu else "cuda")
    for r in records:
        print(json.dumps(r), flush=True)
    return records


def cmd_bench(args):
    """nyu_eval frames/s on the card, one JSON line (bench.py; the
    counterpart of cspn_tpu/cli.py:cmd_bench and the JAX package's bench.py)."""
    from cspn_tpu_torch.bench import run_bench

    return run_bench(device=args.device)


def _add_stereo_args(p: argparse.ArgumentParser):
    p.add_argument("--max-disp", type=int, default=64)
    p.add_argument("--features", type=int, default=16)
    p.add_argument("--prop-step", type=int, default=12)
    p.add_argument("--no-cspn", action="store_true")
    p.add_argument("--dtype", dest="stereo_dtype", default=None, choices=["float32", "bfloat16"],
                   help="conv and activation dtype (bf16 on float32 parameters; the 3D CSPN "
                        "and the disparity regression stay float32)")
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
    _add_tf32(p)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="cspn_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="train on the preset's frames (or synthetic ones)")
    _add_common_overrides(p_train)
    _add_train_overrides(p_train)
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval", help="evaluate best_model on the val set")
    _add_common_overrides(p_eval)
    p_eval.add_argument("--runs", type=int, default=5,
                        help="sparse-resample eval runs to average (README protocol)")
    p_eval.add_argument("--max-batches", type=int, default=None)
    p_eval.add_argument("--dump-images", action="store_true",
                        help="write the first run's %%05d_{input,gt,pred}.png into "
                             "<best_model_dir>/eval_result")
    _add_import(p_eval)
    p_eval.set_defaults(fn=cmd_eval)

    p_inf = sub.add_parser("infer", help="batch inference via the bucketed serving front-end")
    _add_common_overrides(p_inf)
    p_inf.add_argument("--buckets", default="1,8,32,128",
                       help="comma-separated batch buckets")
    p_inf.add_argument("--int8-from", type=int, default=8,
                       help="smallest bucket served int8 (<=0: bf16 only); default 8, the JAX "
                            "package's v5e crossover")
    p_inf.add_argument("--max-frames", type=int, default=None)
    p_inf.add_argument("--seed", type=int, default=0)
    p_inf.add_argument("--out", default=None, help="save predictions to this .npy")
    p_inf.add_argument("--out-dir", default=None,
                       help="where %%05d_pred.png go (default <best_model_dir>/infer_result)")
    _add_import(p_inf)
    p_inf.set_defaults(fn=cmd_infer)

    p_exp = sub.add_parser("export", help="write the eval graph (and the weights) as one "
                                          "torch.export artifact")
    _add_common_overrides(p_exp)
    p_exp.add_argument("--out", default="model.pt2", help="artifact path")
    p_exp.add_argument("--batch", type=int, default=None,
                       help="pin the batch dimension (default: symbolic -- one artifact serves "
                            "any request size)")
    p_exp.add_argument("--height", type=int, default=None)
    p_exp.add_argument("--width", type=int, default=None,
                       help="serving geometry; default the val split's")
    p_exp.add_argument("--no-embed", action="store_true",
                       help="leave the weights, the int8 cache and the static scales out of the "
                            "file; the artifact takes them as its first input")
    p_exp.add_argument("--check", action="store_true",
                       help="reload the artifact and print max|err| against the eager model")
    _add_import(p_exp)
    p_exp.set_defaults(fn=cmd_export)

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

    p_demo = sub.add_parser("demo", help="2D/3D CSPN op demo (paddle demo.py)")
    p_demo.add_argument("--dim-num", type=int, default=3, choices=[2, 3])
    p_demo.add_argument("--feat-chan", type=int, default=1)
    p_demo.add_argument("--prop-kernel", type=int, default=3, choices=[3])
    p_demo.add_argument("--prop-step", type=int, default=24)
    p_demo.add_argument("--batch-size", type=int, default=3)
    p_demo.add_argument("--iter-num", type=int, default=20)
    p_demo.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_demo.set_defaults(fn=cmd_demo)

    p_sc = sub.add_parser("bench-scaling",
                          help="throughput vs mesh size (DP weak scaling; one JSON line per size)")
    p_sc.add_argument("--model", default="resnet18")
    p_sc.add_argument("--height", type=int, default=228)
    p_sc.add_argument("--width", type=int, default=304)
    p_sc.add_argument("--batch-per-device", type=int, default=4)
    p_sc.add_argument("--cspn-step", type=int, default=24)
    p_sc.add_argument("--mode", default="train", choices=["train", "eval", "stereo"],
                      help="stereo = DP weak scaling of the stereo trainer")
    p_sc.add_argument("--mesh-spatial-bench", type=int, default=1,
                      help="spatial axis size (halo-exchange CSPN) per mesh")
    p_sc.add_argument("--force-cpu-devices", type=int, default=0,
                      help="N>0: N gloo ranks on the CPU (default: one card a rank)")
    p_sc.set_defaults(fn=cmd_bench_scaling)

    p_bench = sub.add_parser("bench", help="nyu_eval frames/s on the card: the kernel, int8 and "
                                           "plain reference paths (one JSON line)")
    p_bench.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_bench.set_defaults(fn=cmd_bench)

    p_mm = sub.add_parser("make-manifest",
                          help="generate a datalist CSV of the files under a directory "
                               "(h5 frames by default)")
    p_mm.add_argument("data_dir")
    p_mm.add_argument("out")
    p_mm.add_argument("--pattern", default="**/*.h5")
    p_mm.add_argument("--relative-to", default=None)
    p_mm.set_defaults(fn=cmd_make_manifest)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
