"""Training loop (counterpart of cspn_tpu/train/loop.py:73-94,183-377;
reference train.py).

  - `make_train_step`: forward in train-mode BN, masked L1 (or berHu),
    backward -- through the CUDA CSPN kernels on the card -- SGD step, and
    the metrics of the step's predictions;
  - `_DeviceAverager`: batch-weighted metric sums kept on the device, read
    (and so synchronized) once per epoch;
  - `Trainer`: builds the model and optimizer, imports pretrained encoder
    weights, resumes from a full-state checkpoint, runs epochs with
    best-RMSE tracking, per-epoch and best checkpoints, TSV logs and the
    plateau LR on val MAE.

One device.  Data-parallel training (the JAX package's GSPMD and
grad-reduce-dtype shard_map steps) is not ported: `grad_reduce_dtype` and
a mesh of more than one device raise.  A mesh's spatial axis is a
data-parallel concern here too: the JAX Trainer hands its mesh to no model
(it replicates the batch over 'spatial'); a spatially sharded model is one
a caller builds with `CSPNUNet(spatial_mesh=...)` and drives through
`make_train_step`.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from cspn_tpu_torch import resolve_device, set_conv_policy
from cspn_tpu_torch.config import RunConfig
from cspn_tpu_torch.train import checkpoint as ckpt_lib
from cspn_tpu_torch.train.evaluate import build_model, make_eval_step
from cspn_tpu_torch.train.logging import TsvLogger, format_error
from cspn_tpu_torch.train.loss import LOSSES
from cspn_tpu_torch.train.lr_schedule import ReduceLROnPlateau
from cspn_tpu_torch.train.metrics import METRIC_KEYS, evaluate_error
from cspn_tpu_torch.train.state import TrainState, make_optimizer, partial_restore, set_learning_rate
from cspn_tpu_torch.utils.profiling import StepTimer

_PARALLEL_TODO = (
    "is not ported yet (ROADMAP.md Queue 1 item 2: data-parallel training); "
    "the port trains on one device"
)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, loss_name: str = "l1"):
    """train_step(rgbd [N,H,W,4], depth [N,H,W]) -> (loss, metric dict), both
    on the device.  The gradients stay in the parameters' `.grad` until the
    next step."""
    loss_fn = LOSSES[loss_name]

    def train_step(rgbd, depth):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(rgbd)
        loss = loss_fn(out, depth)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            return loss.detach(), evaluate_error(depth, out.detach())

    return train_step


class _DeviceAverager:
    """Batch-weighted metric averaging with the sums on the device (no
    per-step host sync; converted to floats only when read)."""

    def __init__(self):
        self.sums = None
        self.total = 0

    def update(self, error: dict, batch_size: int):
        v = torch.stack([error[k].float() for k in METRIC_KEYS]) * batch_size
        self.sums = v if self.sums is None else self.sums + v
        self.total += batch_size

    @property
    def average(self) -> dict:
        t = max(self.total, 1)
        sums = [0.0] * len(METRIC_KEYS) if self.sums is None else self.sums.tolist()
        return {k: v / t for k, v in zip(METRIC_KEYS, sums)}


class Trainer:
    def __init__(self, cfg: RunConfig, train_loader, val_loader, pretrained_params=None,
                 device=None, seed: int = 0, tf32: bool = False):
        """`pretrained_params`: a state dict (e.g. models/torch_import.py's)
        merged into the initialized model by name and shape.  `seed` seeds
        the model's init (the JAX package inits from PRNGKey(0)).  `tf32`:
        the convolution policy's (cspn_tpu_torch.set_conv_policy)."""
        if cfg.optim.grad_reduce_dtype:
            raise NotImplementedError(f"grad_reduce_dtype {_PARALLEL_TODO}")
        if (cfg.mesh_data or 1) != 1 or cfg.mesh_spatial != 1:
            raise NotImplementedError(
                f"a mesh of data={cfg.mesh_data}, spatial={cfg.mesh_spatial} {_PARALLEL_TODO}")
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = resolve_device(device)
        set_conv_policy(self.device, tf32=tf32)
        model = build_model(cfg, train=True, device=self.device, seed=seed)
        if pretrained_params is not None:
            partial_restore(model, pretrained_params, verbose=True)
        optimizer = make_optimizer(
            model.parameters(),
            learning_rate=cfg.optim.lr,
            momentum=cfg.optim.momentum,
            weight_decay=cfg.optim.weight_decay,
            nesterov=cfg.optim.nesterov,
            dampening=cfg.optim.dampening,
            momentum_dtype=cfg.optim.momentum_dtype,
        )
        self.state = TrainState(model, optimizer)
        self.scheduler = ReduceLROnPlateau(
            cfg.optim.lr,
            factor=cfg.optim.plateau_factor,
            patience=cfg.optim.plateau_patience,
            min_lr=cfg.optim.plateau_min_lr,
        )
        self.best_rmse = float("inf")
        self.ckpt = ckpt_lib.CheckpointManager(cfg.save_dir)
        self.logger = TsvLogger(cfg.save_dir)
        self.train_step = make_train_step(model, optimizer, cfg.optim.loss)
        self.eval_step = make_eval_step(model, cfg.optim.loss)
        self.epoch = 0

    def _tree(self, epoch: int) -> dict:
        return ckpt_lib.state_to_tree(self.state, epoch, self.best_rmse, self.scheduler.lr)

    def _to_device(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(batch["rgbd"]).to(self.device),
                torch.from_numpy(batch["depth"]).to(self.device))

    # -- reference train.py:151-159 resume-from-best (full state here) ------
    def resume(self, name: str = "best_model"):
        tree = self.ckpt.restore(name, map_location=self.device)
        self.state.model.load_state_dict(tree["model"])
        self.state.optimizer.load_state_dict(tree["optimizer"])
        self.state.step = tree["step"]
        self.epoch = tree["epoch"] + 1
        self.best_rmse = tree["best_rmse"]
        self.scheduler.lr = tree["lr"]

    def train_epoch(self, epoch: int) -> dict:
        avg = _DeviceAverager()
        timer = StepTimer(warmup=2, device=self.device)
        for step, batch in enumerate(self.train_loader):
            rgbd, depth = self._to_device(batch)
            with timer.step(rgbd.shape[0]):
                loss, error = self.train_step(rgbd, depth)
            self.state.step += 1
            avg.update(error, rgbd.shape[0])
            if step % self.cfg.log_every == 0:
                err_now = {k: float(v) for k, v in error.items()}
                print(format_error("train", epoch, step, float(loss), err_now, avg.average),
                      flush=True)
        error_avg = avg.average
        print(f"epoch {epoch} train {timer.summary()}", flush=True)
        self.logger.log("train", epoch, self.scheduler.lr, False, error_avg)
        self.ckpt.save_epoch(self._tree(epoch), epoch)
        return error_avg

    def validate(self, epoch: int) -> dict:
        avg = _DeviceAverager()
        self.state.model.eval()
        loss = torch.zeros(())
        for batch in self.val_loader:
            rgbd, depth = self._to_device(batch)
            _, loss, error = self.eval_step(rgbd, depth)
            avg.update(error, rgbd.shape[0])
        self.state.model.train()
        error_avg = avg.average
        is_best = error_avg["RMSE"] < self.best_rmse
        if is_best:
            self.best_rmse = error_avg["RMSE"]
            self.ckpt.save_best(self._tree(epoch))
        print(format_error("eval", epoch, 0, float(loss), error_avg, error_avg), flush=True)
        self.logger.log("eval", epoch, self.scheduler.lr, is_best, error_avg)
        # plateau LR on val MAE (reference train.py:283)
        set_learning_rate(self.state.optimizer, self.scheduler.step(error_avg["MAE"]))
        return error_avg

    def fit(self, num_epochs: Optional[int] = None) -> dict:
        num_epochs = num_epochs or self.cfg.optim.num_epochs
        last_val: dict = {}
        for epoch in range(self.epoch, num_epochs):
            t0 = time.time()
            self.train_epoch(epoch)
            last_val = self.validate(epoch)
            self.epoch = epoch + 1
            print(
                f"epoch {epoch} done in {time.time() - t0:.1f}s "
                f"(lr={self.scheduler.lr:g}, best RMSE={self.best_rmse:.4f})",
                flush=True,
            )
        return last_val
