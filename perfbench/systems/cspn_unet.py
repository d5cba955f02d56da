"""The CSPN-UNet configurations' two sides.

The program's (cspn_tpu_torch, the system under test): `server` is
`serving.load_server` on a checkpoint of the benchmark's weights;
`trainer` builds the step `Trainer` runs -- `build_model` in train mode,
the SGD optimizer of the configuration, the data-parallel wrapper of a
one-process mesh and `make_train_step`.

The reference's (perfbench/reference/unet.py): the same weights and BN
statistics (the init's: mean 0, variance 1), float32 with TF32 off, or in
the lower precision of a control.

Serving keeps the init's BN statistics: statistics calibrated on a frame
leave channels of random weights with variances near 0, which BN then
scales by ~300, and the served function becomes so ill-conditioned that
bf16 alone moves it by 50-60% (ResNet-50 at 228x304, on the CPU).
"""

from __future__ import annotations

import dataclasses
import pathlib

import torch

from perfbench.reference import layers
from perfbench.reference import unet as ref

# the server's checkpoint, at a fixed path inside the checkout
CHECKPOINTS = pathlib.Path(__file__).resolve().parents[2] / ".perfbench_cache" / "checkpoints"


def _run_config(config: dict, preset: str):
    from cspn_tpu_torch.config import PRESETS

    cfg = PRESETS[preset]
    model = dataclasses.replace(cfg.model, arch=config["arch"], cspn_steps=config["cspn_steps"],
                                cspn_norm_type=config["cspn_norm_type"])
    return dataclasses.replace(cfg, model=model)


def _build(cfg, dtype: str, train: bool, device):
    from cspn_tpu_torch.train.evaluate import build_model

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
    with torch.device(device):  # the modules' own init runs on the card, then is overwritten
        return build_model(cfg, train=train, device=device, seed=None)


@torch.no_grad()
def _load(model, weights: dict) -> None:
    """Copy the benchmark's weights into `model`, which must hold exactly
    these parameters."""
    names = {k for k, _ in model.named_parameters()}
    if names != set(weights):
        raise RuntimeError(f"parameters differ: program only {sorted(names - set(weights))[:5]}, "
                           f"benchmark only {sorted(set(weights) - names)[:5]}")
    state = model.state_dict()
    for k, v in weights.items():
        state[k].copy_(v)


def checkpoint_state(config: dict, weights: dict) -> dict:
    """The state dict of a checkpoint of the benchmark's weights: every
    parameter, and the BN statistics of the init (mean 0, variance 1, no
    batches tracked), floating tensors at bf16, the precision the server
    casts them to at load."""
    state = {k: v.to(torch.bfloat16) for k, v in weights.items()}
    device = next(iter(weights.values())).device
    state.update(ref.bn_buffers(config["arch"], device, torch.bfloat16))
    for name in layers.batch_norms(config["arch"]):
        state[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return state


def server(config: dict, weights: dict, device, **server_kw):
    """The program's own serving entry, `serving.load_server`, at its
    defaults unless `server_kw` (e.g. int8_from=None, every bucket on bf16)
    overrides them, on a checkpoint of the benchmark's weights (at
    CHECKPOINTS), deleted once it has read it."""
    from cspn_tpu_torch.serving import load_server

    cfg = _run_config(config, config["program"]["serve_preset"])
    folder = CHECKPOINTS / config["name"]
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / "benchmark.pt"
    torch.save(checkpoint_state(config, weights), path)
    try:
        with torch.device(device):  # the modules' own init runs on the card, then is overwritten
            return load_server(dataclasses.replace(cfg, best_model_dir=str(folder)), "benchmark",
                               device=device, **server_kw)
    finally:
        path.unlink()


def serve_path(srv, frames: int) -> str:
    """The numeric path ('bf16' or 'int8') the server takes for a request of
    `frames` frames, by its own routing; a request split over buckets of
    two paths is 'int8'."""
    from cspn_tpu_torch.serving import chunk_plan, pick_bucket

    paths = {srv.path_for(pick_bucket(n, srv.buckets)) for n in chunk_plan(frames, srv.buckets)}
    return "int8" if "int8" in paths else "bf16"


def trainer(config: dict, weights: dict, device):
    """(train_step, model, optimizer) as Trainer builds them."""
    from cspn_tpu_torch import set_conv_policy
    from cspn_tpu_torch.parallel.data import DataParallel
    from cspn_tpu_torch.train.loop import default_mesh, make_train_step, reduce_route
    from cspn_tpu_torch.train.state import make_optimizer

    set_conv_policy(device, tf32=False)
    cfg = _run_config(config, config["program"]["train_preset"])
    model = _build(cfg, "float32", True, device)
    _load(model, weights)
    t = config["train"]
    opt = make_optimizer(model.parameters(), learning_rate=t["lr"], momentum=t["momentum"],
                         weight_decay=t["weight_decay"], nesterov=t["nesterov"],
                         dampening=t["dampening"], momentum_dtype=None)
    mesh = default_mesh(None, 1)
    dp = DataParallel(model, mesh, reduce_route(None, mesh))
    return make_train_step(model, opt, t["loss"], dp), model, opt


@torch.no_grad()
def first_gradient_norms(model, optimizer) -> dict:
    """Per leaf, the norm of the gradient the optimizer took at its first
    step (grad + weight decay x p, SGD's momentum buffer after one step)."""
    out = {}
    for k, p in model.named_parameters():
        buf = optimizer.state[p].get("momentum_buffer")
        out[k] = float("nan") if buf is None else float(buf.float().norm())
    return out


# -- the reference side ----------------------------------------------------

def _policy(tf32: bool):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def reference_net(config: dict, weights: dict, device, quant=None, tf32=False) -> ref.Net:
    _policy(tf32)
    params = {k: v.detach().clone() for k, v in weights.items()}
    return ref.Net(config["arch"], params, ref.bn_buffers(config["arch"], device),
                   config["cspn_steps"], config["cspn_norm_type"], quant)


@torch.no_grad()
def reference_serve(config: dict, weights: dict, frames, device, quant=None,
                    block: int = 8):
    """The reference's depth for `frames` [n, H, W, 4] (host or device),
    in blocks of `block` frames."""
    net = reference_net(config, weights, device, quant)
    outs = [net(torch.as_tensor(frames[i:i + block]).to(device)).cpu()
            for i in range(0, len(frames), block)]
    _policy(False)
    return torch.cat(outs)


def reference_train(config: dict, weights: dict, batches, device, tf32=False, half_batch=False):
    """The reference's first len(batches) steps: (losses, first gradient
    per leaf, parameters after the steps)."""
    net = reference_net(config, weights, device, tf32=tf32)
    if half_batch:  # a fault: the step sees the first half of each batch only
        batches = [(x[: len(x) // 2], y[: len(y) // 2]) for x, y in batches]
    t = config["train"]
    losses, first = ref.train_steps(net, batches, t["lr"], t["momentum"], t["weight_decay"],
                                    t["nesterov"])
    _policy(False)
    return [float(x) for x in losses], first, net.p
