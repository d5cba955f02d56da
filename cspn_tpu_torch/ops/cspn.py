"""Public CSPN op API with backend dispatch (counterpart of
cspn_tpu/ops/cspn.py:34-104).

Backends:
    'kernel'    -- the hand-written CUDA kernel (ops/cspn_cuda.py); CUDA
                   tensors only.
    'reference' -- the plain PyTorch version (ops/cspn_ref.py), any device,
                   autograd-native.
    'auto'      -- the kernel for CUDA tensors, the reference otherwise.
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops import cspn_ref

BACKENDS = ("auto", "kernel", "reference")


def _io_dtype(io_dtype) -> torch.dtype | None:
    """A torch dtype, or the config's names ('float32' = no rounding)."""
    if io_dtype is None or isinstance(io_dtype, torch.dtype):
        return io_dtype
    return {"float32": None, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}[io_dtype]


def _round_io(guidance, blur_depth, sparse_depth, io_dtype):
    """Emulate reduced-precision kernel I/O on paths that read f32: round
    the inputs through io_dtype (the kernel upcasts at first use, so this is
    the identical function)."""
    dt = _io_dtype(io_dtype)
    if dt is None:
        return guidance, blur_depth, sparse_depth
    return (
        guidance.to(dt).float(),
        blur_depth.to(dt).float(),
        None if sparse_depth is None else sparse_depth.to(dt).float(),
    )


def _reference(guidance, blur_depth, sparse_depth, steps, norm_type, channel_first, io_dtype):
    g = guidance.movedim(1, -1) if channel_first else guidance
    g, b, s = _round_io(g, blur_depth, sparse_depth, io_dtype)
    return cspn_ref.cspn2d_reference(g, b, s, steps=steps, norm_type=norm_type)


def cspn2d(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    steps: int = 24,
    norm_type: str = "8sum",
    backend: str = "auto",
    io_dtype=None,
    channel_first: bool = False,
) -> torch.Tensor:
    """2D CSPN post-process (pytorch reference semantics); see
    cspn_ref.cspn2d_reference.  guidance is [N, H, W, 8], or [N, 8, H, W]
    with channel_first=True; depth maps are [N, H, W]."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    on_cuda = guidance.device.type == "cuda"
    if backend == "kernel" and not on_cuda:
        raise ValueError(
            f"backend='kernel' needs CUDA tensors, got {guidance.device}; "
            "use 'reference' (or 'auto') on the CPU"
        )
    if backend == "reference" or not on_cuda:
        return _reference(guidance, blur_depth, sparse_depth, steps, norm_type,
                          channel_first, io_dtype)
    from cspn_tpu_torch.ops.cspn_cuda import cspn2d_cuda

    return cspn2d_cuda(
        guidance, blur_depth, sparse_depth, steps=steps, norm_type=norm_type,
        channel_first=channel_first, io_dtype=io_dtype,
    )
