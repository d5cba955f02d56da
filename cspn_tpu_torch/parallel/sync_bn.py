"""Batch norm over the global batch of a data-parallel run (counterpart of
the JAX package's GSPMD train step, which computes BatchNorm's batch
statistics over the whole sharded batch: cspn_tpu/train/loop.py:1-12).

`SyncBatchNorm` keeps the semantics of the port's `BatchNorm2d`
(models/resnet.py): eps 1e-5, momentum 0.1, the batch's biased variance to
normalize, and a running variance that is unbiased over the GLOBAL count.
In training mode each call gathers every rank's per-channel count, mean
and sum of squared deviations (one all_gather; the ranks' parts are
combined as Chan et al.'s parallel variance, so no sum of squares
cancels) and normalizes with them in one fused pass (eval-mode
`F.batch_norm` on the global statistics); its backward all-reduces the
two per-channel sums of the input gradient, sum dy and sum dy * x_hat.
The weight and bias gradients stay this rank's, for DistributedDataParallel
to average.  In eval mode it is the port's batch norm on the running
statistics (models/resnet.py: normalizing in the JAX package's dtype).

One implementation on both devices: `torch.nn.SyncBatchNorm` refuses CPU
tensors, so the CPU tests could not hold it against the JAX package.
`convert_sync_batchnorm` swaps every batch norm of a model for it, keeping
parameters and buffers (state dict keys are unchanged).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F
from torch.nn.modules.batchnorm import _BatchNorm

from cspn_tpu_torch.models.resnet import NormInPromotedDtype


def _stats(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(global count, mean [C], biased variance [C]) of x [N, C, ...] over
    every rank of `group`, in promote(x's dtype, float32): a bf16 input's
    statistics are float32, as JAX's BatchNorm takes them."""
    dims = [0, *range(2, x.ndim)]
    count = x.numel() // x.shape[1]
    var, mean = torch.var_mean(x.to(torch.promote_types(x.dtype, torch.float32)), dims,
                               correction=0)  # one pass
    part = torch.cat([mean.new_full((1,), float(count)), mean, var * count])
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, part, group=group)
    parts = torch.stack(parts)  # [ranks, 1 + 2C]
    c = x.shape[1]
    n_r, mean_r, m2_r = parts[:, :1], parts[:, 1:1 + c], parts[:, 1 + c:]
    n = n_r.sum()
    g_mean = (n_r * mean_r).sum(0) / n
    g_m2 = (m2_r + n_r * (mean_r - g_mean).square()).sum(0)
    return n, g_mean, g_m2 / n


class _SyncBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum, group):
        n, mean, var = _stats(x, group)
        if running_mean is not None:
            with torch.no_grad():
                running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
                running_var.mul_(1 - momentum).add_(var * (n / (n - 1).clamp_min(1)),
                                                    alpha=momentum)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps), n)
        ctx.group = group
        # the normalization with the global statistics: one fused pass
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims = [0, *range(2, dy.ndim)]
        shape = (1, -1, *[1] * (dy.ndim - 2))
        x_hat = torch.addcmul((-mean * invstd).view(shape), x, invstd.view(shape))
        out_dtype, dy = dy.dtype, dy.to(x_hat.dtype)  # a bf16 cotangent sums in float32
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * x_hat).sum(dims)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        g_dy, g_dy_xhat = sums.chunk(2)
        # dx = w invstd (dy - sum dy / n - x_hat sum dy x_hat / n), as two addcmuls
        scale = weight * invstd
        dx = torch.addcmul((-scale * g_dy / n).view(shape), x_hat,
                           (-scale * g_dy_xhat / n).view(shape))
        dx = torch.addcmul(dx, dy, scale.view(shape)).to(out_dtype)
        # this rank's parameter gradients; DistributedDataParallel averages them
        return dx, sum_dy_xhat, sum_dy, None, None, None, None, None


class SyncBatchNorm(NormInPromotedDtype, _BatchNorm):
    """Batch norm whose training-mode statistics span every rank of
    `group` (None: the default process group).  Affine and tracking
    running statistics, as the port's models build their batch norms."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1, group=None):
        super().__init__(num_features, eps, momentum, affine=True, track_running_stats=True)
        self.group = group

    def _check_input_dim(self, x):
        if x.ndim < 3:
            raise ValueError(f"expected an input of 3 or more dims [N, C, ...], got {x.ndim}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return _SyncBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                    self.running_var, self.eps, self.momentum, self.group)


def convert_sync_batchnorm(module: nn.Module, group=None) -> nn.Module:
    """`module` with every batch norm (affine, tracking running statistics,
    momentum set) swapped for a SyncBatchNorm over `group`, its parameters
    and buffers kept; returns the module (the same object unless `module`
    itself is a batch norm)."""
    if isinstance(module, _BatchNorm) and not isinstance(module, SyncBatchNorm):
        if not (module.affine and module.track_running_stats and module.momentum is not None):
            raise ValueError(f"{module}: only affine batch norms with running statistics and a "
                             "momentum are converted")
        sync = SyncBatchNorm(module.num_features, module.eps, module.momentum, group)
        sync.training = module.training
        with torch.no_grad():
            sync.weight, sync.bias = module.weight, module.bias
            sync.running_mean, sync.running_var = module.running_mean, module.running_var
            sync.num_batches_tracked = module.num_batches_tracked
        return sync
    for name, child in module.named_children():
        module.add_module(name, convert_sync_batchnorm(child, group))
    return module
