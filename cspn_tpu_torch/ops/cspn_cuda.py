"""Hopper kernel for the 2D CSPN forward (counterpart of
cspn_tpu/ops/cspn_pallas.py:cspn2d_pallas and its _fwd_kernel).

The kernel is hand-written CUDA C++ in csrc/cspn2d_fwd.cu (its header says
what bounds it and what the design leaves open), built by ops/_build.py and
called through ctypes on PyTorch's current stream.

`cspn2d_cuda` is the wrapper.  A tensor on the CPU goes to the kernel's
plain version (ops/cspn_ref.py) because it lies on the CPU; a CUDA tensor
goes to the kernel or raises.  There is no fallback between the two.

`launches` counts the kernel's runs: one per forward, which is one `prep`
launch plus `steps` `step` launches on the card.
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn import _reference, _round_io

launches = 0

_BACKWARD_TODO = (
    "the backward of the 2D CSPN CUDA kernel is not ported yet "
    "(ROADMAP.md Queue 2 item 2, cspn_pallas.py:_bwd_kernel); "
    "use backend='reference' to differentiate"
)


def _check_inputs(guid_cf, blur, sparse, norm_type):
    cspn_ref.check_norm_type(norm_type)
    if guid_cf.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {guid_cf.device}")
    if guid_cf.ndim != 4 or guid_cf.shape[1] != 8:
        raise ValueError(f"guidance must be [N,8,H,W], got {tuple(guid_cf.shape)}")
    n, _, h, w = guid_cf.shape
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit 65535")
    for name, t in (("guidance", guid_cf), ("blur_depth", blur), ("sparse_depth", sparse)):
        if t is None:
            continue
        if t.device != guid_cf.device:
            raise ValueError(f"{name} on {t.device}, guidance on {guid_cf.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not guid_cf and tuple(t.shape) != (n, h, w):
            raise ValueError(f"{name} must be [{n},{h},{w}], got {tuple(t.shape)}")


def _launch(guid_cf, blur, sparse, steps: int, norm_type: str) -> torch.Tensor:
    """Run the kernel on already checked inputs; returns [N, H, W] f32."""
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("cspn2d_fwd")
    n, _, h, w = guid_cf.shape
    out = torch.empty_like(blur)
    gates = torch.empty_like(guid_cf)
    base = torch.empty_like(blur)
    x_scratch = torch.empty_like(blur)
    with torch.cuda.device(guid_cf.device):  # the runtime launches on the current device
        err = lib.cspn2d_fwd_f32(
            guid_cf.data_ptr(), blur.data_ptr(),
            None if sparse is None else sparse.data_ptr(),
            out.data_ptr(), gates.data_ptr(), base.data_ptr(), x_scratch.data_ptr(),
            n, h, w, int(steps), int(norm_type == "8sum_abs"),
            torch.cuda.current_stream(guid_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_fwd_f32 launch failed: cudaError_t {err}")
    launches += 1
    return out


class _Cspn2dFwd(torch.autograd.Function):
    """Forward = the CUDA kernel.  Backward is the next kernel to port."""

    @staticmethod
    def forward(ctx, guid_cf, blur, sparse, steps, norm_type):
        return _launch(guid_cf, blur, sparse, steps, norm_type)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_BACKWARD_TODO)


def cspn2d_cuda(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    steps: int = 24,
    norm_type: str = "8sum",
    channel_first: bool = False,
    io_dtype=None,
) -> torch.Tensor:
    """Fused 2D CSPN (pytorch reference semantics, cspn.py:42-83).

    Args:
        guidance: [N, H, W, 8] (or [N, 8, H, W] with channel_first=True).
        blur_depth: [N, H, W].
        sparse_depth: optional [N, H, W].
        io_dtype: emulated I/O dtype of the inputs (e.g. torch.bfloat16):
            they are rounded through it, then the f32 kernel runs.
    Returns [N, H, W] float32.
    """
    if guidance.device.type == "cpu":
        return _reference(guidance, blur_depth, sparse_depth, steps, norm_type,
                          channel_first, io_dtype)
    g, b, s = _round_io(guidance, blur_depth, sparse_depth, io_dtype)
    g_cf = (g if channel_first else g.movedim(-1, 1)).contiguous()
    _check_inputs(g_cf, b, s, norm_type)
    return _Cspn2dFwd.apply(g_cf, b, s, steps, norm_type)
