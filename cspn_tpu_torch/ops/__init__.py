"""CSPN ops: the plain PyTorch reference, the Hopper kernel and the
dispatching public API."""

from cspn_tpu_torch.ops.cspn import cspn2d
from cspn_tpu_torch.ops.cspn_ref import cspn2d_reference, normalize_affinity_2d, propagate_2d

__all__ = ["cspn2d", "cspn2d_reference", "normalize_affinity_2d", "propagate_2d"]
