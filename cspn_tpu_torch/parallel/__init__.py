"""Spatially sharded CSPN with halo exchange over a spatial mesh
(counterpart of cspn_tpu/parallel; data-parallel sharding, `shard_batch`
and `replicate`, waits for DDP: ROADMAP.md Queue 1 item 2)."""

from cspn_tpu_torch.parallel.halo import cspn2d_spatial, cspn_nd_spatial
from cspn_tpu_torch.parallel.mesh import make_mesh

__all__ = ["cspn2d_spatial", "cspn_nd_spatial", "make_mesh"]
