"""The device mesh (counterpart of cspn_tpu/parallel/mesh.py: make_mesh,
shard_batch, replicate).

The JAX package lays its devices out as a `jax.sharding.Mesh` of D x S:
the batch is sharded over the 'data' axis (data parallelism), and image
rows (or cost-volume depth) over the 'spatial' axis, with halo rows
exchanged by `lax.ppermute`.  Here a `Mesh` of a process group of D x S
ranks (rank r at data index r // S and spatial index r % S, as JAX
reshapes its devices) says which rows of a global batch this rank holds
(`shard_batch`; the D ranks of one spatial index form `data_group`, over
which DistributedDataParallel reduces), and where the S row blocks live,
and moves rows between them:

  - in process (`make_mesh(spatial=S)`): the S blocks live on the caller's
    device, stacked along the batch dimension (block-major: block s holds
    batch rows s*N .. s*N+N-1), so that one kernel launch runs a segment
    for all of them.  The single-card counterpart of the JAX package's
    multi-device mesh (the tests' 8-device CPU mesh, tests/conftest.py).
    The exchange slices and concatenates neighbouring blocks, zeros beyond
    the first and the last; autograd differentiates it.
  - process group (`make_mesh(spatial=S, group=pg)`): each of the S ranks
    of `pg` owns one block and exchanges its edge rows with its neighbours
    through torch.distributed point-to-point ops (`batch_isend_irecv`).
    The exchange's backward is the transpose of `ppermute`: it sends the
    cotangent of each received halo back to the rank it came from, which
    adds it into its own edge rows.  Each rank slices its rows out of the
    full (replicated) input, and the output is gathered along rows, as the
    JAX package's `out_specs` returns the global array; the slice's
    backward gathers the row blocks' cotangents and the gather's backward
    keeps this rank's rows, so every rank ends with the full gradient.

Rows are dimension 1 of every tensor the mesh moves.  A mesh without a
process group holds one data index (D = 1).
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S = `spatial` row blocks, in this process (`group` None) or one per
    rank of the torch.distributed process group `group`; and D = `data`
    data indices, one per rank of `data_group` (None: this process alone)."""

    spatial: int
    group: object = None
    data: int = 1
    data_group: object = None

    @property
    def data_rank(self) -> int:
        """This process's data index."""
        return 0 if self.data_group is None else dist.get_rank(self.data_group)

    @property
    def local_blocks(self) -> int:
        """Row blocks this process holds, stacked along the batch."""
        return self.spatial if self.group is None else 1

    def split_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The full [N, H, ...] -> this process's blocks [local_blocks * N,
        H / S, ...]."""
        if x.shape[1] % self.spatial:
            raise ValueError(f"{x.shape[1]} rows do not split into {self.spatial} blocks")
        if self.group is None:
            return x.unflatten(1, (self.spatial, -1)).movedim(1, 0).flatten(0, 1)
        return _ScatterRows.apply(x, self.group)

    def join_rows(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of `split_rows`: the full [N, H, ...] on every rank."""
        if self.group is None:
            return y.unflatten(0, (self.spatial, -1)).movedim(0, 1).flatten(1, 2)
        return _GatherRows.apply(y, self.group)

    def exchange(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """Each block [.., h, ..] extended to h + 2k rows: k rows of its
        upper neighbour's bottom, its own, k rows of its lower neighbour's
        top; zeros beyond the first and the last block (the image border)."""
        if self.group is None:
            xs = x.unflatten(0, (self.spatial, -1))
            zero = xs.new_zeros((1, xs.shape[1], k, *xs.shape[3:]))
            top = torch.cat([zero, xs[:-1, :, -k:]])
            bottom = torch.cat([xs[1:, :, :k], zero])
            return torch.cat([top, xs, bottom], dim=2).flatten(0, 1)
        return _HaloExchange.apply(x, k, self.group)


def make_mesh(data: int | None = None, spatial: int = 1, group=None) -> Mesh:
    """A `data` x `spatial` mesh.  Without `group`: the S blocks in this
    process, one data index.  With `group` (a process group of D x S ranks;
    `data` None: every rank on the data axis, D = ranks / S): rank r of
    `group` holds data index r // S and spatial index r % S.  Every rank of
    `group` must call it (it creates the data and spatial subgroups)."""
    if spatial < 1:
        raise ValueError(f"spatial must be >= 1, got {spatial}")
    if group is None:
        if data not in (None, 1):
            raise ValueError(f"a data axis of {data} needs a process group of {data} x {spatial} "
                             "ranks (torchrun, or parallel/distributed.py:initialize_multihost)")
        return Mesh(spatial)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    data = size // spatial if data is None else data
    if data < 1 or data * spatial != size:
        raise ValueError(f"group of {size} ranks for a {data} x {spatial} mesh")
    ranks = [dist.get_global_rank(group, r) for r in range(size)]

    def subgroup(members):
        # new_group is collective: every rank creates every subgroup, in one order
        return group if len(members) == size else dist.new_group(members)

    data_groups = [subgroup(ranks[s::spatial]) for s in range(spatial)]
    spatial_groups = [subgroup(ranks[d * spatial:(d + 1) * spatial]) for d in range(data)]
    return Mesh(spatial, spatial_groups[rank // spatial] if spatial > 1 else None, data,
                data_groups[rank % spatial])


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of each [B, ...] array or tensor in `batch` (B / D
    rows, data index `mesh.data_rank`; the S ranks of one data index hold
    the same rows), as JAX's shard_batch shards the leading axis over
    'data'."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.data:
            raise ValueError(f"{k}: a batch of {v.shape[0]} does not split over {mesh.data} "
                             "data indices")
        rows = v.shape[0] // mesh.data
        out[k] = v[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]
    return out


def replicate(module: torch.nn.Module, group=None, src: int = 0) -> torch.nn.Module:
    """Every parameter and buffer of `module` broadcast from rank `src` of
    `group` (JAX's replicate puts one copy on every device); a no-op
    without an initialized process group."""
    if not dist.is_initialized():
        return module
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            dist.broadcast(t, dist.get_global_rank(group or dist.group.WORLD, src), group=group)
    return module


def _send_recv(to_prev: torch.Tensor, to_next: torch.Tensor, group):
    """Send `to_prev` to the rank above and `to_next` to the rank below;
    returns (what the rank above sent, what the rank below sent), zeros
    where there is no such rank."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    from_prev, from_next = to_next.new_zeros(to_next.shape), to_prev.new_zeros(to_prev.shape)
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if rank < size - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """`Mesh.exchange` across the ranks of a process group."""

    @staticmethod
    def forward(ctx, x, k, group):
        ctx.k, ctx.group = k, group
        top, bottom = _send_recv(x[:, :k], x[:, -k:], group)
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    def backward(ctx, grad):
        k = ctx.k
        gx = grad[:, k:-k].clone()
        # the cotangent of a received halo goes back to the rank it came
        # from and adds into the edge rows that rank sent
        from_prev, from_next = _send_recv(grad[:, :k], grad[:, -k:], ctx.group)
        gx[:, :k] += from_prev
        gx[:, -k:] += from_next
        return gx, None, None


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    parts = [x.new_empty(x.shape) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group)
    return torch.cat(parts, dim=1)


def _own_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=1)[dist.get_rank(group)].contiguous()


class _ScatterRows(torch.autograd.Function):
    """This rank's row block of a replicated tensor."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_rows(grad, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """Every rank's row block, joined: the replicated full tensor."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _all_gather_rows(y, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_rows(grad, ctx.group), None
