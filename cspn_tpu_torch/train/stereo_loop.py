"""Stereo training loop (counterpart of cspn_tpu/train/stereo_loop.py;
BASELINE config 5: PSMNet-style model + 3D CSPN).

  - `StereoConfig`: the JAX package's fields and defaults;
  - `build_stereo_model`: the configured PSMNetCSPN on a device, seeded;
  - `make_stereo_train_step`: forward in train-mode BN, masked smooth-L1,
    backward -- through the 3D CSPN kernels on the card -- and the SGD step;
    with `train_only`, only the parameters whose name holds that substring
    are updated (and decayed), and the other modules' BN running statistics
    stay as they were while they still normalize with batch statistics
    (the JAX package's optax.multi_transform + set_to_zero and its
    batch-stats pinning);
  - `make_stereo_eval_step`: eval-mode forward, loss and EPE/3px/D1;
  - `StereoTrainer`: epochs of training, validation with best-EPE
    `best_model` checkpoints, `run_eval` (restore, metrics, optional uint16
    disparity*256 PNG dumps) and `fit`.

SGD is torch's (momentum 0.9, weight decay 1e-4, no Nesterov; the JAX
package's train/state.py:make_optimizer).  Checkpoints are one `torch.save`
file each (train/checkpoint.py), holding the model's state dict, the epoch
and the best EPE, as the JAX package's Orbax tree holds params, batch
statistics, epoch and best EPE.  `train_only` matches the port's
parameter and buffer names (`guidance3d_head.weight`), which hold the JAX
tree path's module names (`['guidance3d_head']['kernel']`).  On a mesh
with a data axis (JAX stereo_loop.py:116-160) each rank trains a replica
on its rows of every global batch, through train/loop.py's two
data-parallel routes (parallel/data.py); every rank validates on its
replica and rank 0 alone writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from cspn_tpu_torch import resolve_device, set_conv_policy
from cspn_tpu_torch.models.stereo import PSMNetCSPN, end_point_error, smooth_l1_disparity_loss
from cspn_tpu_torch.parallel.data import DataParallel
from cspn_tpu_torch.parallel.distributed import local_device
from cspn_tpu_torch.parallel.mesh import shard_batch
from cspn_tpu_torch.train import checkpoint as ckpt_lib
from cspn_tpu_torch.train.loop import default_mesh, is_main_process, reduce_route
from cspn_tpu_torch.train.state import make_optimizer

METRICS = ("EPE", "3px", "D1")


@dataclasses.dataclass
class StereoConfig:
    max_disp: int = 192
    features: int = 32
    cspn_steps: int = 24
    use_cspn: bool = True
    dtype: str = "float32"  # or "bfloat16": the convs in bf16 on float32 parameters
    lr: float = 1e-3
    num_epochs: int = 10
    batch_size: int = 4
    save_dir: str = "result/stereo_cspn"
    # when set, ONLY parameters whose name contains this substring are
    # trained (no update, no weight decay for the others) and the frozen
    # modules' BN running statistics are pinned too
    train_only: Optional[str] = None
    # zero-init the 3D guidance head so the CSPN starts as an exact identity
    guidance_zero_init: bool = False


def build_stereo_model(cfg: StereoConfig, train: bool = False, device=None, seed: Optional[int] = 0,
                       cspn_backend: str = "auto") -> PSMNetCSPN:
    """The configured PSMNetCSPN on `device` (default cuda), in train or
    eval mode; `seed` (None: PyTorch's default init) seeds the JAX-style
    init with a torch.Generator on that device."""
    dev = resolve_device(device)
    gen = None if seed is None else torch.Generator(dev).manual_seed(seed)
    with torch.device(dev):
        model = PSMNetCSPN(
            max_disp=cfg.max_disp,
            features=cfg.features,
            cspn_steps=cfg.cspn_steps,
            use_cspn=cfg.use_cspn,
            guidance_zero_init=cfg.guidance_zero_init,
            dtype=cfg.dtype,
            cspn_backend=cspn_backend,
            generator=gen,
        )
    return model.train(train)


def _frozen_buffers(model: torch.nn.Module, train_only: Optional[str]) -> dict:
    if train_only is None:
        return {}
    return {k: b for k, b in model.named_buffers() if train_only not in k}


def make_stereo_train_step(model: PSMNetCSPN, optimizer: torch.optim.Optimizer, max_disp: float,
                           train_only: Optional[str] = None,
                           data_parallel: Optional[DataParallel] = None):
    """train_step(left, right, disp) -> (loss, metric dict), on the device.
    The gradients stay in the parameters' `.grad` until the next step.
    With `data_parallel` (of `model`), the step runs its module and its
    reduce; loss and metrics come back averaged over the ranks."""
    frozen = _frozen_buffers(model, train_only)
    forward = model if data_parallel is None else data_parallel.module

    def train_step(left, right, disp):
        model.train()
        pinned = {k: b.clone() for k, b in frozen.items()}
        model.zero_grad(set_to_none=True)
        out = forward(left, right)
        loss = smooth_l1_disparity_loss(out, disp, max_disp)
        valid = ((disp > 0) & (disp < max_disp)).sum()  # the pixels the loss and metrics average
        if data_parallel is not None:
            loss = data_parallel.scale_loss(loss, valid)
        loss.backward()
        if data_parallel is not None:
            data_parallel.after_backward()
        optimizer.step()
        with torch.no_grad():
            for k, b in pinned.items():  # frozen modules keep their running stats
                frozen[k].copy_(b)
            loss, error = loss.detach(), end_point_error(out.detach(), disp, max_disp)
            if data_parallel is not None:
                loss, error = data_parallel.after_step(loss, error, dict.fromkeys(error, valid))
            return loss, error

    return train_step


def make_stereo_eval_step(model: PSMNetCSPN, max_disp: float):
    """eval_step(left, right, disp) -> (pred, loss, metric dict)."""

    @torch.inference_mode()
    def eval_step(left, right, disp):
        model.eval()
        out = model(left, right)
        return out, smooth_l1_disparity_loss(out, disp, max_disp), end_point_error(out, disp, max_disp)

    return eval_step


class StereoTrainer:
    def __init__(self, cfg: StereoConfig, train_loader, val_loader, device=None, seed: int = 0,
                 tf32: bool = False, grad_reduce_dtype: Optional[str] = None):
        """`seed` seeds the model's init (the JAX package inits from
        PRNGKey(0)); `tf32` is the convolution policy's
        (cspn_tpu_torch.set_conv_policy).  Every rank of the default process
        group is on the data axis (this process alone without one), and
        `grad_reduce_dtype` picks the data-parallel route, as the Trainer's
        (train/loop.py)."""
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.mesh = default_mesh(None, 1)
        self.device = local_device(resolve_device(device))
        set_conv_policy(self.device, tf32=tf32)
        self.model = build_stereo_model(cfg, train=True, device=self.device, seed=seed)
        params = [p for k, p in self.model.named_parameters()
                  if cfg.train_only is None or cfg.train_only in k]
        self.optimizer = make_optimizer(params, cfg.lr, momentum=0.9, weight_decay=1e-4,
                                        nesterov=False)
        self.data_parallel = DataParallel(self.model, self.mesh,
                                          reduce_route(grad_reduce_dtype, self.mesh))
        self.train_step = make_stereo_train_step(self.model, self.optimizer, cfg.max_disp,
                                                 train_only=cfg.train_only,
                                                 data_parallel=self.data_parallel)
        self.eval_step = make_stereo_eval_step(self.model, cfg.max_disp)
        self.main = is_main_process()
        self.ckpt = ckpt_lib.CheckpointManager(cfg.save_dir)
        self.best_epe = float("inf")
        self.epoch = 0

    def _to_device(self, batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return tuple(torch.from_numpy(batch[k]).to(self.device) for k in ("left", "right", "disp"))

    def _log(self, msg: str) -> None:
        if self.main:
            print(msg, flush=True)

    def train_epoch(self, epoch: int) -> float:
        losses = []
        for batch in self.train_loader:
            rows = shard_batch({k: batch[k] for k in ("left", "right", "disp")}, self.mesh)
            loss, _ = self.train_step(*self._to_device(rows))
            losses.append(loss)
        mean_loss = float(torch.stack(losses).mean())
        self._log(f"stereo epoch {epoch}: train loss {mean_loss:.4f}")
        return mean_loss

    def validate(self, epoch: int) -> dict:
        sums = {k: [] for k in METRICS}
        for batch in self.val_loader:
            _, _, m = self.eval_step(*self._to_device(batch))
            for k in sums:
                sums[k].append(m[k])
        self.model.train()
        epe, px3, d1 = (float(torch.stack(sums[k]).mean()) for k in METRICS)
        self._log(f"stereo epoch {epoch}: val EPE {epe:.3f} 3px {px3:.4f} D1 {d1:.4f}")
        if epe < self.best_epe:
            self.best_epe = epe
            if self.main:
                self.ckpt.save_best({"model": self.model.state_dict(), "epoch": int(epoch),
                                     "best_epe": float(self.best_epe)})
        return {"EPE": epe, "3px": px3, "D1": d1}

    def run_eval(self, checkpoint: str = "best_model", dump_images: bool = False,
                 out_dir: Optional[str] = None) -> dict:
        """Restore `checkpoint` from save_dir (if present), compute EPE /
        >3px / D1 over the val loader (batch-weighted), optionally dump
        %05d_disp.png predictions and %05d_gt.png (KITTI uint16
        disparity*256 convention)."""
        if self.ckpt.has(checkpoint):
            tree = self.ckpt.restore(checkpoint, map_location=self.device)
            self.model.load_state_dict(tree["model"])
            self._log(f"==> loaded {checkpoint} from {self.cfg.save_dir}")
        sums = dict.fromkeys(METRICS, 0.0)
        total = 0
        index = 0
        out_dir = out_dir or f"{self.cfg.save_dir}/eval_result"
        for batch in self.val_loader:
            pred, _, m = self.eval_step(*self._to_device(batch))
            bs = pred.shape[0]
            for k in sums:
                sums[k] += float(m[k]) * bs
            total += bs
            if dump_images and self.main:
                from cspn_tpu_torch.utils.images import write_png

                os.makedirs(out_dir, exist_ok=True)
                pred_np = pred.cpu().numpy()
                for j in range(bs):
                    for tag, img in (("disp", pred_np[j]), ("gt", np.asarray(batch["disp"][j]))):
                        u16 = np.clip(img * 256.0, 0, 65535).astype(np.uint16)
                        write_png(f"{out_dir}/{index:05d}_{tag}.png", u16)
                    index += 1
        self.model.train()
        mean = {k: sums[k] / max(total, 1) for k in sums}
        self._log("stereo eval: EPE {EPE:.3f}  3px {3px:.4f}  D1 {D1:.4f}".format(**mean))
        return mean

    def fit(self, num_epochs: Optional[int] = None) -> dict:
        num_epochs = num_epochs or self.cfg.num_epochs
        result = {}
        for epoch in range(self.epoch, num_epochs):
            t0 = time.time()
            self.train_epoch(epoch)
            result = self.validate(epoch)
            self.epoch = epoch + 1
            self._log(f"stereo epoch {epoch} done in {time.time() - t0:.1f}s")
        return result
