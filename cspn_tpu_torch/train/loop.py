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

Data-parallel over a mesh's data axis (the JAX package's GSPMD step and,
with `grad_reduce_dtype`, its shard_map step): under a torch.distributed
process group of `mesh_data` x `mesh_spatial` ranks (torchrun, or
parallel/distributed.py:initialize_multihost) each rank trains a replica
through DistributedDataParallel on its rows of every global batch
(parallel/data.py: sync-BN and a float32 reduce, or per-replica BN and a
bfloat16 reduce), runs the whole validation set on its replica, as JAX
validates its replicated state, and rank 0 alone writes checkpoints and
logs.  Without a process group it trains in this process.  A mesh's
spatial axis replicates the step: the JAX Trainer hands its mesh to no
model; a spatially sharded model is one a caller builds with
`CSPNUNet(spatial_mesh=...)` and drives through `make_train_step`.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch
import torch.distributed as dist

from cspn_tpu_torch import resolve_device, set_conv_policy
from cspn_tpu_torch.config import RunConfig
from cspn_tpu_torch.parallel.data import DataParallel
from cspn_tpu_torch.parallel.distributed import local_device
from cspn_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from cspn_tpu_torch.train import checkpoint as ckpt_lib
from cspn_tpu_torch.train.evaluate import build_model, make_eval_step
from cspn_tpu_torch.train.logging import TsvLogger, format_error
from cspn_tpu_torch.train.loss import LOSSES, VALID_THRESHOLD, berhu_loss
from cspn_tpu_torch.train.lr_schedule import ReduceLROnPlateau
from cspn_tpu_torch.train.metrics import METRIC_KEYS, ROOT_KEYS, evaluate_error, metric_counts
from cspn_tpu_torch.train.state import TrainState, make_optimizer, partial_restore, set_learning_rate
from cspn_tpu_torch.utils.profiling import StepTimer
from cspn_tpu_torch.utils.tracing import span

def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, loss_name: str = "l1",
                    data_parallel: Optional[DataParallel] = None):
    """train_step(rgbd [N,H,W,4], depth [N,H,W]) -> (loss, metric dict), both
    on the device.  The gradients stay in the parameters' `.grad` until the
    next step.  With `data_parallel` (of `model`), the step runs its
    module and its reduce; loss and metrics come back averaged over the
    ranks.  On the sync-BN route berHu's threshold spans the global batch
    (train/loss.py), as in the JAX package's GSPMD step.  Under a
    torch.profiler session each statement of the step lies in one span
    (utils/tracing.py): `step.optimizer` (train mode and zero_grad),
    `step.forward`, `step.loss`, `step.backward`, `step.optimizer`
    (optimizer.step), `step.metrics`."""
    loss_fn = LOSSES[loss_name]
    group = None if data_parallel is None else data_parallel.loss_group
    if loss_name == "berhu" and group is not None:
        loss_fn = functools.partial(berhu_loss, group=group)
    forward = model if data_parallel is None else data_parallel.module

    def train_step(rgbd, depth):
        with span("step.optimizer"):
            model.train()
            optimizer.zero_grad(set_to_none=True)
        with span("step.forward"):
            out = forward(rgbd)
        with span("step.loss"):
            loss = loss_fn(out, depth)
            if data_parallel is not None:
                loss = data_parallel.scale_loss(loss, (depth > VALID_THRESHOLD).sum())
        with span("step.backward"):
            loss.backward()
            if data_parallel is not None:
                data_parallel.after_backward()
        with span("step.optimizer"):
            optimizer.step()
        with span("step.metrics"), torch.no_grad():
            loss, error = loss.detach(), evaluate_error(depth, out.detach())
            if data_parallel is not None:
                loss, error = data_parallel.after_step(loss, error, metric_counts(depth, out),
                                                       ROOT_KEYS)
            return loss, error

    return train_step


def default_mesh(mesh_data: Optional[int], mesh_spatial: int) -> Mesh:
    """The run's mesh: over every rank of the default process group where
    one exists, else this process (which takes a data axis of 1)."""
    group = dist.group.WORLD if dist.is_initialized() else None
    return make_mesh(mesh_data, mesh_spatial, group)


def reduce_route(grad_reduce_dtype: Optional[str], mesh: Mesh) -> Optional[str]:
    """The gradient reduce's dtype on `mesh`: as given on a data-only mesh;
    None (the GSPMD route) with a note where the mesh has a spatial axis,
    as the JAX Trainer does (cspn_tpu/train/loop.py:271-289)."""
    if grad_reduce_dtype and mesh.spatial != 1:
        print("# grad_reduce_dtype ignored: shard_map step needs a data-only mesh (spatial=1)",
              flush=True)
        return None
    return grad_reduce_dtype


def is_main_process() -> bool:
    """Rank 0 of the process group, or the one process: the writer of
    checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


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
        the convolution policy's (cspn_tpu_torch.set_conv_policy).  The
        step is trained over cfg.mesh_data x cfg.mesh_spatial on the
        default process group (`default_mesh`)."""
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.mesh = default_mesh(cfg.mesh_data, cfg.mesh_spatial)
        self.device = local_device(resolve_device(device))
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
        self.main = is_main_process()
        self.ckpt = ckpt_lib.CheckpointManager(cfg.save_dir)
        self.logger = TsvLogger(cfg.save_dir) if self.main else None
        route = reduce_route(cfg.optim.grad_reduce_dtype, self.mesh)
        self.data_parallel = DataParallel(model, self.mesh, route)
        self.train_step = make_train_step(model, optimizer, cfg.optim.loss, self.data_parallel)
        self.eval_step = make_eval_step(model, cfg.optim.loss)
        self.epoch = 0

    def _tree(self, epoch: int) -> dict:
        return ckpt_lib.state_to_tree(self.state, epoch, self.best_rmse, self.scheduler.lr)

    def _to_device(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        with span("step.h2d"):
            return (torch.from_numpy(batch["rgbd"]).to(self.device),
                    torch.from_numpy(batch["depth"]).to(self.device))

    def _log(self, msg: str) -> None:
        if self.main:
            print(msg, flush=True)

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
            frames = batch["rgbd"].shape[0]  # the global batch; this rank trains its rows
            rgbd, depth = self._to_device(shard_batch({k: batch[k] for k in ("rgbd", "depth")},
                                                      self.mesh))
            with timer.step(frames):
                loss, error = self.train_step(rgbd, depth)
            self.state.step += 1
            avg.update(error, frames)
            if step % self.cfg.log_every == 0:
                err_now = {k: float(v) for k, v in error.items()}
                self._log(format_error("train", epoch, step, float(loss), err_now, avg.average))
        error_avg = avg.average
        self._log(f"epoch {epoch} train {timer.summary()}")
        if self.main:
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
            if self.main:
                self.ckpt.save_best(self._tree(epoch))
        self._log(format_error("eval", epoch, 0, float(loss), error_avg, error_avg))
        if self.main:
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
            self._log(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                      f"(lr={self.scheduler.lr:g}, best RMSE={self.best_rmse:.4f})")
        return last_val
