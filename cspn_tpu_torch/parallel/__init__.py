"""Device meshes (counterpart of cspn_tpu/parallel): the spatially sharded
CSPN with halo exchange over a mesh's spatial axis, and data-parallel
training over its data axis (`shard_batch`, `replicate`; the port's own
sync-BN, parallel/sync_bn.py; DistributedDataParallel's gradient reduce,
parallel/data.py)."""

from cspn_tpu_torch.parallel.halo import cspn2d_spatial, cspn_nd_spatial
from cspn_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["cspn2d_spatial", "cspn_nd_spatial", "make_mesh", "replicate", "shard_batch"]
