"""Train state and optimizer (counterpart of cspn_tpu/train/state.py; reference
train.py:169-177).

SGD(lr, momentum 0.9, weight decay 1e-4, nesterov) is `torch.optim.SGD`,
whose update is the JAX package's optax chain (decayed weights added to the
gradient, the trace started at the first gradient, Nesterov's g + mu*buf,
dampening only without Nesterov).  `momentum_dtype='bfloat16'` stores the
momentum buffer in bf16 and does the update in f32, as optax's
`accumulator_dtype` does.  The learning rate lives in the optimizer's
param_groups, where the host-side ReduceLROnPlateau sets it between epochs.

`partial_restore` copies every entry of a state dict whose name and shape
match the target's and keeps the rest (the reference's checkpoint key
surgery, models/update_model.py:13-31): used for resuming and for importing
pretrained encoder weights into the 4-channel-stem model.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


class SGDLowPrecisionMomentum(torch.optim.Optimizer):
    """torch.optim.SGD's update with the momentum buffer stored in
    `momentum_dtype` (e.g. bf16, half the buffer's bytes).  The buffer is
    read into f32, updated there, used for the step in f32 and rounded only
    when stored, as optax.trace(accumulator_dtype=...) does."""

    def __init__(self, params, lr: float, momentum: float, dampening: float,
                 weight_decay: float, nesterov: bool, momentum_dtype: torch.dtype):
        super().__init__(params, dict(lr=lr, momentum=momentum, dampening=dampening,
                                      weight_decay=weight_decay, nesterov=nesterov))
        self.momentum_dtype = momentum_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not supported")
        for group in self.param_groups:
            mu, damp = group["momentum"], group["dampening"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float() + group["weight_decay"] * p.float()
                st = self.state[p]
                if "momentum_buffer" in st:
                    buf = mu * st["momentum_buffer"].float() + (1.0 - damp) * g
                else:
                    buf = g.clone()  # the first step starts the trace at g
                st["momentum_buffer"] = buf.to(self.momentum_dtype)
                upd = g + mu * buf if group["nesterov"] else buf
                p.add_(upd.to(p.dtype), alpha=-group["lr"])

    def load_state_dict(self, state_dict):
        # Optimizer.load_state_dict casts floating state to the parameter's
        # dtype; keep the buffer in its storage dtype
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "momentum_buffer" in st:
                st["momentum_buffer"] = st["momentum_buffer"].to(self.momentum_dtype)


def _momentum_dtype(momentum_dtype) -> torch.dtype | None:
    if momentum_dtype is None or isinstance(momentum_dtype, torch.dtype):
        return momentum_dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "bf16": torch.bfloat16}[momentum_dtype]


def make_optimizer(
    params,
    learning_rate: float = 0.01,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    nesterov: bool = True,
    dampening: float = 0.0,
    momentum_dtype=None,
) -> torch.optim.Optimizer:
    """SGD + Nesterov + weight decay (reference train.py:170-175).

    momentum_dtype: storage dtype of the momentum buffer; None (or float32)
    keeps one f32 buffer per parameter, 'bfloat16' halves it."""
    if dampening and nesterov:
        raise ValueError("nesterov requires dampening == 0 (torch semantics)")
    dt = _momentum_dtype(momentum_dtype)
    if dt is None or dt == torch.float32:
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum, dampening=dampening,
                               weight_decay=weight_decay, nesterov=nesterov)
    return SGDLowPrecisionMomentum(params, learning_rate, momentum, dampening, weight_decay,
                                   nesterov, dt)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the number of optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Use `lr` for the optimizer's subsequent steps."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def partial_restore(model: nn.Module, source: dict, verbose: bool = False) -> nn.Module:
    """Load the entries of the state dict `source` whose name and shape match
    `model`'s into it, in place; every other entry keeps its value."""
    target = model.state_dict()
    n_copied = 0
    for key, value in source.items():
        if key in target and tuple(target[key].shape) == tuple(value.shape):
            target[key] = value
            n_copied += 1
    model.load_state_dict(target)
    if verbose:
        print(f"partial_restore: copied {n_copied}/{len(target)} leaves")
    return model
