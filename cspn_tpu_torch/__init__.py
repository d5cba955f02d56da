"""cspn_tpu_torch: the PyTorch / CUDA port of cspn_tpu for one NVIDIA H100.

The JAX package `cspn_tpu` stays the reference; this package imports
nothing of it (tests/test_torch_purity.py enforces that).  Plain tensor work
is PyTorch; every Pallas kernel of `cspn_tpu` on a ported path has a
hand-written Hopper counterpart under `csrc/` (see PERF.md for the table).

Entry points run on `cuda` unless the caller passes `device="cpu"`; a CUDA
request on a machine without a card raises.  The entry points that serve,
evaluate or train (`Trainer`, `StereoTrainer`, `run_eval`, `load_server`)
set the process's convolution policy for the card (`set_conv_policy`)
before they build a model; the model builders leave it alone.
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


def set_conv_policy(device, *, autotune: bool = True, tf32: bool = False) -> None:
    """The process's convolution and matmul policy on a CUDA device, the one
    place the entry points set it (a CPU device leaves it alone):

    - `autotune`: cuDNN times its algorithms at each new shape
      (torch.backends.cudnn.benchmark), as XLA autotunes the JAX package's
      GPU convolutions; without, its heuristic alone picks them, and it
      picks FFT algorithms for kitti_benchmark's batch-4 convs that take
      ~25x the time of those the timing finds (PERF.md, kitti_benchmark).
      cuDNN keeps the algorithm it first chose for a shape, so set this
      before the first convolution.
    - `tf32`: float32 convolutions and matmuls in TF32 on the tensor cores
      (cudnn.allow_tf32, cuda.matmul.allow_tf32), the counterpart of the
      JAX package's precision choice (cspn_tpu/utils/precision.py, where
      the TPU computes float32 convolutions in bf16 passes).  Off by
      default: every tolerance and card check of the port is set in IEEE
      float32, and PERF.md records what TF32 buys (`--tf32` turns it on).
    """
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.benchmark = autotune
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
