"""The spatial mesh (counterpart of cspn_tpu/parallel/mesh.py:make_mesh).

The JAX package shards image rows (or cost-volume depth) over the
'spatial' axis of a `jax.sharding.Mesh` and exchanges halo rows with
`lax.ppermute`.  Here a `Mesh` says where the S row blocks live, and moves
rows between them:

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

Rows are dimension 1 of every tensor the mesh moves.  A data axis larger
than 1 is data parallelism, not ported yet (ROADMAP.md Queue 1 item 2,
DDP); `shard_batch` and `replicate` belong to it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S = `spatial` row blocks, in this process (`group` None) or one per
    rank of the torch.distributed process group `group`."""

    spatial: int
    group: object = None

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


def make_mesh(data: int | None = 1, spatial: int = 1, group=None) -> Mesh:
    """A 1 x `spatial` mesh: the S blocks in this process, or one per rank
    of `group` (its size must be S)."""
    if data not in (None, 1):
        raise NotImplementedError(
            f"a data axis of {data} is data-parallel training, not ported yet (ROADMAP.md "
            "Queue 1 item 2: DDP); make_mesh takes data=1")
    if spatial < 1:
        raise ValueError(f"spatial must be >= 1, got {spatial}")
    if group is not None and dist.get_world_size(group) != spatial:
        raise ValueError(f"group of {dist.get_world_size(group)} ranks for {spatial} blocks")
    return Mesh(spatial, group)


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
