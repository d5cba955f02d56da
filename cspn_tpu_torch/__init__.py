"""cspn_tpu_torch: the PyTorch / CUDA port of cspn_tpu for one NVIDIA H100.

The JAX package `cspn_tpu` stays the reference; this package imports
nothing of it (tests/test_torch_purity.py enforces that).  Plain tensor work
is PyTorch; every Pallas kernel of `cspn_tpu` on a ported path has a
hand-written Hopper counterpart under `csrc/` (see PERF.md for the table).

Entry points run on `cuda` unless the caller passes `device="cpu"`; a CUDA
request on a machine without a card raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`device` (default 'cuda') as a torch.device; raises if it names CUDA
    and no card is visible, instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
