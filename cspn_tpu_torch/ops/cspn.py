"""Public CSPN op API with backend dispatch (counterpart of
cspn_tpu/ops/cspn.py).

Backends:
    'kernel'    -- the hand-written CUDA kernels (ops/cspn_cuda.py for the
                   2D op, ops/cspn_paddle2d_cuda.py for the 2D `cspn_nd`,
                   ops/cspn3d_cuda.py for the 3D one); CUDA tensors only.
    'reference' -- the plain PyTorch version (ops/cspn_ref.py), any device,
                   autograd-native.
    'auto'      -- the kernel for CUDA tensors, the reference otherwise.

`cspn_nd` on CUDA with kernel_size 3 runs the 2D or 3D kernels at every
size (no fallback to the reference by size, unlike cspn_pallas.py:1492-1494);
other kernel sizes, for which the JAX package has no kernel either, run the
reference under 'auto'.
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


def affinity_propagate(
    feat: torch.Tensor,
    gate_weight: torch.Tensor,
    kernel_size: int = 3,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """One propagation step (paddle native-op semantics), 2D or 3D; see
    cspn_ref.affinity_propagate_reference.  One step is plain PyTorch on
    every backend, as the JAX package leaves it to XLA."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return cspn_ref.affinity_propagate_reference(feat, gate_weight, kernel_size)


def cspn_nd(
    guide: torch.Tensor,
    feat: torch.Tensor,
    *,
    kernel_size: int = 3,
    steps: int = 24,
    backend: str = "auto",
    channel_first: bool = False,
) -> torch.Tensor:
    """Multi-step 2D/3D CSPN module (paddle demo semantics); see
    cspn_ref.cspn_nd_reference.  guide is [N, *spatial, C*(k^n-1)] and feat
    [N, *spatial, C], or [N, C*(k^n-1), *spatial] and [N, C, *spatial] with
    channel_first=True."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    on_cuda = feat.device.type == "cuda"
    if backend == "kernel" and not on_cuda:
        raise ValueError(
            f"backend='kernel' needs CUDA tensors, got {feat.device}; "
            "use 'reference' (or 'auto') on the CPU"
        )
    ndim = feat.ndim - 2
    if on_cuda and backend != "reference":
        if ndim == 3 and kernel_size == 3:
            from cspn_tpu_torch.ops.cspn3d_cuda import cspn3d_cuda

            return cspn3d_cuda(guide, feat, steps=steps, channel_first=channel_first)
        if ndim == 2 and kernel_size == 3:
            from cspn_tpu_torch.ops.cspn_paddle2d_cuda import cspn2d_paddle_cuda

            # the kernel reads either layout as it lies; a view is copied first
            return cspn2d_paddle_cuda(guide.contiguous(), feat.contiguous(), steps=steps,
                                      channel_first=channel_first)
        if backend == "kernel":
            raise NotImplementedError(f"no CSPN kernel for {ndim}D with kernel_size {kernel_size}")
    g = guide.movedim(1, -1) if channel_first else guide
    f = feat.movedim(1, -1) if channel_first else feat
    out = cspn_ref.cspn_nd_reference(g, f, kernel_size=kernel_size, steps=steps)
    return out.movedim(-1, 1) if channel_first else out
