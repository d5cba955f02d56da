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
from cspn_tpu_torch.data import batches
from cspn_tpu_torch.models.convert import load_jax_variables
from cspn_tpu_torch.models.resnet import init_weights
from cspn_tpu_torch.models.unet import LAYERS, CSPNUNet
from cspn_tpu_torch.train.factory import build_dataset
from cspn_tpu_torch.train.logging import format_error
from cspn_tpu_torch.train.loss import LOSSES
from cspn_tpu_torch.train.metrics import METRIC_KEYS, evaluate_error


def build_model(cfg: RunConfig, train: bool = False, device=None, seed: int | None = 0) -> CSPNUNet:
    """The configured CSPNUNet on `device` (default cuda), in train or eval
    mode; `seed` (None: PyTorch's default init) seeds the he_normal init
    with a torch.Generator on that device."""
    if cfg.model.dtype != "float32":
        raise NotImplementedError(
            f"dtype {cfg.model.dtype!r} is not ported yet (ROADMAP.md Queue 1: "
            "bf16/int8 serving); this slice serves float32"
        )
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
                    jax_variables=None) -> CSPNUNet:
    """The eval-mode model with its weights: `jax_variables` (the JAX
    package's {'params', 'batch_stats'} as numpy, converted by
    models/convert.py) when given, else the `torch.save`d state dict
    `<cfg.best_model_dir>/<checkpoint>.pt` when it exists, else random
    weights (seed 0) with a warning.  `<checkpoint>.pt` may be a bare state
    dict or a training checkpoint of train/checkpoint.py.  The JAX
    package's Orbax checkpoints need JAX to read and are not read here."""
    model = build_model(cfg, train=False, device=device)
    if jax_variables is not None:
        load_jax_variables(model, jax_variables)
        print("==> loaded converted JAX parameters")
        return model
    path = os.path.join(cfg.best_model_dir, f"{checkpoint}.pt")
    if os.path.exists(path):
        sd = torch.load(path, map_location=next(model.parameters()).device, weights_only=True)
        # a training checkpoint (train/checkpoint.py) holds the state dict under "model"
        model.load_state_dict(sd["model"] if "model" in sd else sd)
        print(f"==> loaded {path}")
    else:
        print(f"==> WARNING: no {path}; random params")
    return model


def run_eval(cfg: RunConfig, runs: int = 5, checkpoint: str = "best_model",
             max_batches: int | None = None, device=None, jax_variables=None,
             tf32: bool = False) -> dict:
    """`runs` passes over the val split (module docstring); `tf32` is the
    convolution policy's (cspn_tpu_torch.set_conv_policy)."""
    set_conv_policy(resolve_device(device), tf32=tf32)
    model = load_eval_state(cfg, checkpoint, device=device, jax_variables=jax_variables)
    eval_step = make_eval_step(model, cfg.optim.loss)
    dev = next(model.parameters()).device

    run_avgs = []
    for run in range(runs):
        ds = build_dataset(cfg, "val", seed=run)
        sums = np.zeros(len(METRIC_KEYS))
        total = 0
        for batch in batches(ds, cfg.data.batch_size_eval, max_batches):
            rgbd = torch.from_numpy(batch["rgbd"]).to(dev)
            depth = torch.from_numpy(batch["depth"]).to(dev)
            _, _, error = eval_step(rgbd, depth)
            bs = rgbd.shape[0]
            sums += np.asarray(torch.stack([error[k] for k in METRIC_KEYS]).tolist()) * bs
            total += bs
        avg = {k: float(v) / max(total, 1) for k, v in zip(METRIC_KEYS, sums)}
        run_avgs.append(avg)
        print(format_error(f"eval_run_{run}", 0, total, 0.0, avg, avg), flush=True)

    mean = {k: float(np.mean([a[k] for a in run_avgs])) for k in METRIC_KEYS}
    print(format_error(f"eval_mean_of_{runs}_runs", 0, 0, 0.0, mean, mean), flush=True)
    return {"runs": run_avgs, "mean": mean}
