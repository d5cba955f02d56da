"""Evaluation driver (counterpart of cspn_tpu/train/evaluate.py:28-161 and
the model/eval-step builders of cspn_tpu/train/loop.py:41-66,183-199).

Since the Bernoulli sparse input makes eval stochastic, `run_eval` runs the
reference README's protocol (cspn_pytorch/README.md:73): `runs` passes over
the val split, each re-seeding the sparse sampler, reporting per-run and
mean metrics.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cspn_tpu_torch import resolve_device, set_conv_policy
from cspn_tpu_torch.config import RunConfig
from cspn_tpu_torch.data import DataLoader
from cspn_tpu_torch.models.convert import load_jax_variables
from cspn_tpu_torch.models.resnet import init_weights
from cspn_tpu_torch.models.torch_import import load_torch_cspn_checkpoint
from cspn_tpu_torch.models.unet import LAYERS, CSPNUNet
from cspn_tpu_torch.train.factory import build_dataset
from cspn_tpu_torch.train.logging import format_error
from cspn_tpu_torch.train.loss import LOSSES
from cspn_tpu_torch.train.metrics import METRIC_KEYS, evaluate_error
from cspn_tpu_torch.train.state import partial_restore
from cspn_tpu_torch.utils.images import save_eval_images
from cspn_tpu_torch.utils.precision import cast_floating, torch_dtype
from cspn_tpu_torch.utils.quant import build_act_calibration, build_weight_qcache


def build_model(cfg: RunConfig, train: bool = False, device=None, seed: int | None = 0) -> CSPNUNet:
    """The configured CSPNUNet on `device` (default cuda), in train or eval
    mode; `seed` (None: PyTorch's default init) seeds the he_normal init
    with a torch.Generator on that device.  cfg.model.dtype 'bfloat16'
    computes the conv net in bf16 on float32 parameters; 'int8' is the bf16
    model with int8 convs (`quant`), and only for serving: a training model
    stays bf16 (cspn_tpu/train/loop.py:43-63)."""
    dev = resolve_device(device)
    block, layers = LAYERS[int(cfg.model.arch.replace("resnet", ""))]
    model = CSPNUNet(
        block=block,
        layers=layers,
        cspn_steps=cfg.model.cspn_steps,
        cspn_norm_type=cfg.model.cspn_norm_type,
        use_cspn=cfg.model.use_cspn,
        cspn_backend=cfg.model.cspn_backend,
        cspn_io_dtype=cfg.model.cspn_io_dtype,
        dtype=torch_dtype(cfg.model.dtype),
        quant=cfg.model.dtype == "int8" and not train,
        quant_exclude=tuple(cfg.model.quant_exclude),
    ).to(dev)
    if seed is not None:
        init_weights(model, torch.Generator(dev).manual_seed(seed))
    return model.train(train)


def calibrate_bn_stats(model: torch.nn.Module, *inputs: torch.Tensor) -> torch.nn.Module:
    """Set every BN's running statistics to those of the batch `inputs`
    (one train-mode forward `model(*inputs)` at momentum 1), then switch to
    eval mode: real statistics for a randomly initialized model, where
    eval-mode BN at the init statistics is numerically meaningless."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(*inputs)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    return model.eval()


def make_eval_step(model: torch.nn.Module, loss_name: str = "l1"):
    """eval_step(rgbd [N,H,W,4], depth [N,H,W]) -> (pred, loss, metric dict)."""
    loss_fn = LOSSES[loss_name]

    @torch.inference_mode()
    def eval_step(rgbd, depth):
        out = model(rgbd)
        return out, loss_fn(out, depth), evaluate_error(depth, out)

    return eval_step


def load_eval_state(cfg: RunConfig, checkpoint: str = "best_model", device=None,
                    jax_variables=None, torch_checkpoint: str | None = None) -> CSPNUNet:
    """The eval-mode model with its weights: `jax_variables` (the JAX
    package's {'params', 'batch_stats'} as numpy, converted by
    models/convert.py) when given, else `torch_checkpoint`, a whole model
    trained by the reference (best_model.pth; models/torch_import.py:
    load_torch_cspn_checkpoint, merged by train/state.py:partial_restore,
    as cspn_tpu/train/evaluate.py:56-66), else the `torch.save`d state dict
    `<cfg.best_model_dir>/<checkpoint>.pt` when it exists, else random
    weights (seed 0) with a warning.  `<checkpoint>.pt` may be a bare state
    dict or a training checkpoint of train/checkpoint.py.  The JAX
    package's Orbax checkpoints need JAX to read and are not read here.

    Serving precision (cspn_tpu/train/evaluate.py:28-106): at 'bfloat16'
    and 'int8' every floating tensor is cast to bf16 at load
    (utils/precision.py:cast_floating; checkpoints keep float32 masters).
    At 'int8' the QuantConvs' weights are quantized once
    (utils/quant.py:build_weight_qcache), and with cfg.model.act_static the
    static activation scales are calibrated on up to 8 frames of the val
    split (utils/quant.py:build_act_calibration)."""
    model = build_model(cfg, train=False, device=device)
    if jax_variables is not None:
        load_jax_variables(model, jax_variables)
        print("==> loaded converted JAX parameters")
    elif torch_checkpoint:
        partial_restore(model, load_torch_cspn_checkpoint(torch_checkpoint), verbose=True)
        print(f"==> imported reference torch checkpoint {torch_checkpoint}")
    else:
        path = os.path.join(cfg.best_model_dir, f"{checkpoint}.pt")
        if os.path.exists(path):
            sd = torch.load(path, map_location=next(model.parameters()).device, weights_only=True)
            # a training checkpoint (train/checkpoint.py) holds the state dict under "model"
            model.load_state_dict(sd["model"] if "model" in sd else sd)
            print(f"==> loaded {path}")
        else:
            print(f"==> WARNING: no {path}; random params")
    if cfg.model.dtype in ("bfloat16", "int8"):
        model.load_state_dict(cast_floating(model.state_dict()), assign=True)
    if cfg.model.dtype == "int8":
        build_weight_qcache(model)
        print("==> cached int8 weight quantization (per output channel, load time)")
        if cfg.model.act_static:
            ds = build_dataset(cfg, "val", seed=0)
            dev = next(model.parameters()).device
            calib = np.stack([ds[i]["rgbd"] for i in range(min(8, len(ds)))])
            build_act_calibration(model, [torch.from_numpy(calib).to(dev)])
            print("==> calibrated static int8 activation scales (load time)")
    return model


def run_eval(cfg: RunConfig, runs: int = 5, checkpoint: str = "best_model",
             max_batches: int | None = None, device=None, jax_variables=None,
             tf32: bool = False, dump_images: bool = False,
             torch_checkpoint: str | None = None) -> dict:
    """`runs` passes over the val split (module docstring), each through a
    DataLoader of cfg.data.num_workers workers (the first `max_batches`
    batches of it, when given); `tf32` is the
    convolution policy's (cspn_tpu_torch.set_conv_policy).  `dump_images`
    writes the first run's frames as %05d_{input,gt,pred}.png into
    <cfg.best_model_dir>/eval_result (utils/images.py); `torch_checkpoint`
    is load_eval_state's."""
    set_conv_policy(resolve_device(device), tf32=tf32)
    model = load_eval_state(cfg, checkpoint, device=device, jax_variables=jax_variables,
                            torch_checkpoint=torch_checkpoint)
    eval_step = make_eval_step(model, cfg.optim.loss)
    dev = next(model.parameters()).device

    run_avgs = []
    for run in range(runs):
        dump = dump_images and run == 0
        ds = build_dataset(cfg, "val", seed=run, return_raw_rgb=dump)
        loader = DataLoader(ds, cfg.data.batch_size_eval, num_workers=cfg.data.num_workers,
                            worker_mode=cfg.data.worker_mode)
        sums = np.zeros(len(METRIC_KEYS))
        total = 0
        for bi, batch in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            rgbd = torch.from_numpy(batch["rgbd"]).to(dev)
            depth = torch.from_numpy(batch["depth"]).to(dev)
            pred, _, error = eval_step(rgbd, depth)
            bs = rgbd.shape[0]
            sums += np.asarray(torch.stack([error[k] for k in METRIC_KEYS]).tolist()) * bs
            if dump:
                pred_np = pred.float().cpu().numpy()
                for j in range(bs):
                    save_eval_images(cfg.data.dataset, cfg.best_model_dir, total + j,
                                     batch["raw_rgb"][j], batch["depth"][j], pred_np[j], raw=True)
            total += bs
        avg = {k: float(v) / max(total, 1) for k, v in zip(METRIC_KEYS, sums)}
        run_avgs.append(avg)
        print(format_error(f"eval_run_{run}", 0, total, 0.0, avg, avg), flush=True)

    mean = {k: float(np.mean([a[k] for a in run_avgs])) for k in METRIC_KEYS}
    print(format_error(f"eval_mean_of_{runs}_runs", 0, 0, 0.0, mean, mean), flush=True)
    return {"runs": run_avgs, "mean": mean}
