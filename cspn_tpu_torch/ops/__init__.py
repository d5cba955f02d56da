"""CSPN ops: the plain PyTorch reference, the Hopper kernels, the linear
resizes and the dispatching public API."""

from cspn_tpu_torch.ops.cspn import affinity_propagate, cspn2d, cspn_nd
from cspn_tpu_torch.ops.cspn_ref import (
    affinity_propagate_reference,
    cspn2d_reference,
    cspn_nd_reference,
    normalize_affinity_2d,
    propagate_2d,
)
from cspn_tpu_torch.ops.resize import resize_bilinear, resize_trilinear

__all__ = [
    "affinity_propagate",
    "affinity_propagate_reference",
    "cspn2d",
    "cspn2d_reference",
    "cspn_nd",
    "cspn_nd_reference",
    "normalize_affinity_2d",
    "propagate_2d",
    "resize_bilinear",
    "resize_trilinear",
]
