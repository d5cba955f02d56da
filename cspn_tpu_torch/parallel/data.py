"""Data-parallel training over a mesh's data axis with
DistributedDataParallel (counterpart of the JAX package's two
data-parallel train steps, cspn_tpu/train/loop.py:97-180 and :271-289).

`DataParallel` wraps a model for one of the two routes JAX offers:

  - `grad_reduce_dtype=None` (JAX's GSPMD step): every batch norm becomes
    the port's SyncBatchNorm (parallel/sync_bn.py), so the batch
    statistics span the global batch, and the gradients are averaged in
    float32;
  - `grad_reduce_dtype='bfloat16'` (JAX's make_shard_map_train_step):
    batch norm per replica; each gradient bucket is cast to bfloat16,
    all-reduced, divided by the ranks and cast back (JAX casts, pmeans and
    casts back, :147-152); after each step the running statistics are
    averaged over the ranks (JAX pmeans the per-shard updates, :154).

Both routes reduce through the port's DDP communication hook (`ReduceHook`),
which counts the bytes it reduces per dtype: the buckets as DDP hands them
(float32) and, on the bf16 route, the bfloat16 bytes on the wire, half as
many.  DDP is built with broadcast_buffers=False: its default broadcasts
rank 0's buffers before every forward, which is another result than the
average.

The loss and the metrics follow each route's JAX step.  GSPMD takes the
masked mean loss and the masked metrics over the global batch: on the
default route `scale_loss` turns each shard's masked mean into R n_r / N
times it (n_r the shard's valid pixels, N the global batch's, R the
ranks), so that DDP's average of the ranks' gradients is the gradient of
the global masked mean, and `after_step` weights each rank's metric by
its count (a root-mean metric such as RMSE by its square).  The shard_map
step pmeans the shards' losses and metrics and takes RMSE from the
pmeaned MSE (JAX :156-163): so does the bf16 route.

Without a process group (`mesh.data_group` None) the model is trained in
this process alone; the bf16 route then rounds each gradient to bfloat16
and back, as JAX's shard_map step does on one device.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from cspn_tpu_torch.parallel.mesh import Mesh
from cspn_tpu_torch.parallel.sync_bn import convert_sync_batchnorm

REDUCE_DTYPES = {None: None, "bfloat16": torch.bfloat16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class ReduceHook:
    """State of `_reduce_hook`: the data group, the wire dtype (None: the
    buckets' own) and `bytes`, the bytes reduced so far by dtype."""

    def __init__(self, group, dtype: torch.dtype | None = None):
        self.group, self.dtype = group, dtype
        self.bytes: collections.Counter = collections.Counter()


def _reduce_hook(state, bucket):
    """The bucket's gradients averaged over the ranks at state.dtype: a DDP
    communication hook (state a ReduceHook, bucket a dist.GradBucket;
    returns a Future of the bucket's tensor).  Unannotated: DDP compares
    the annotations with classes, and this module's are strings."""
    buf = bucket.buffer()
    state.bytes[_dtype_name(buf.dtype)] += buf.numel() * buf.element_size()
    wire = buf if state.dtype is None else buf.to(state.dtype)
    if wire is not buf:
        state.bytes[_dtype_name(wire.dtype)] += wire.numel() * wire.element_size()
    ranks = dist.get_world_size(state.group)
    fut = dist.all_reduce(wire, group=state.group, async_op=True).get_future()

    def mean(f):
        total = f.value()[0].div_(ranks)  # pmean: the sum, then divided
        if total is not buf:
            buf.copy_(total)
        return buf

    return fut.then(mean)


class DataParallel:
    """`model` trained over `mesh`'s data axis: `module` is what the train
    step calls (a DistributedDataParallel of `model` under a process group,
    else `model`), `hook` the reduce's byte counts (None without a group)."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, grad_reduce_dtype=None):
        if grad_reduce_dtype not in REDUCE_DTYPES:
            raise ValueError(f"grad_reduce_dtype {grad_reduce_dtype!r}: 'bfloat16' or None")
        self.model, self.group = model, mesh.data_group
        self.dtype = REDUCE_DTYPES[grad_reduce_dtype]
        self.module, self.hook = model, None
        if self.group is None:
            return
        if self.dtype is None:
            convert_sync_batchnorm(model, self.group)
        device = next(model.parameters()).device
        self.module = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=self.group, broadcast_buffers=False)
        self.hook = ReduceHook(self.group, self.dtype)
        self.module.register_comm_hook(self.hook, _reduce_hook)

    @property
    def ranks(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    def scale_loss(self, loss: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        """The default route under a process group: this shard's masked
        mean `loss` over its `n_valid` pixels times R n_r / N, whose
        average over the ranks is the global batch's masked mean."""
        if self.group is None or self.dtype is not None:
            return loss
        total = n_valid.detach().to(loss.dtype).reshape(1).clone()
        dist.all_reduce(total, group=self.group)
        return loss * (self.ranks * n_valid.clamp_min(1) / total.clamp_min(1))[0]

    def after_backward(self) -> None:
        """One process on the bf16 route: each gradient rounded to bf16."""
        if self.group is None and self.dtype is not None:
            with torch.no_grad():
                for p in self.model.parameters():
                    if p.grad is not None:
                        p.grad.copy_(p.grad.to(self.dtype))

    @torch.no_grad()
    def after_step(self, loss: torch.Tensor, error: dict, counts: dict,
                   roots=()) -> tuple[torch.Tensor, dict]:
        """Per-replica batch norm: the running statistics averaged over the
        ranks.  The loss averaged over the ranks, and the metrics: on the
        default route each weighted by its count in `counts` (the shard's
        pixels it averages over; a metric in `roots`, the root of a mean,
        by its square), on the bf16 route averaged, RMSE from the averaged
        MSE."""
        if self.group is None:
            return loss, error
        keys = list(error)
        if self.dtype is None:
            sums = torch.stack([loss, *(counts[k].to(loss.dtype) * (error[k].to(loss.dtype) ** 2
                                                                     if k in roots else error[k])
                                        for k in keys),
                                *(counts[k].to(loss.dtype) for k in keys)])
            dist.all_reduce(sums, group=self.group)
            means = sums[1:1 + len(keys)] / sums[1 + len(keys):].clamp_min(1)
            error = {k: means[i].sqrt() if k in roots else means[i] for i, k in enumerate(keys)}
            return sums[0] / self.ranks, error
        if self.dtype is not None:
            bufs = [b for b in self.model.buffers() if b.is_floating_point()]
            if bufs:
                flat = torch.cat([b.reshape(-1) for b in bufs])
                dist.all_reduce(flat, group=self.group)
                flat.div_(self.ranks)
                for b, v in zip(bufs, flat.split([b.numel() for b in bufs])):
                    b.copy_(v.view_as(b))
        vals = torch.stack([loss, *(error[k].to(loss.dtype) for k in keys)])
        dist.all_reduce(vals, group=self.group)
        vals.div_(self.ranks)
        error = dict(zip(keys, vals[1:].unbind()))
        if "MSE" in error and "RMSE" in error:
            error["RMSE"] = torch.sqrt(error["MSE"])
        return vals[0], error
