"""Hopper kernels for the 2D CSPN forward and backward (counterpart of
cspn_tpu/ops/cspn_pallas.py:cspn2d_pallas, its _fwd_kernel and _bwd_kernel).

The kernels are hand-written CUDA C++ in csrc/cspn2d_fwd.cu and
csrc/cspn2d_bwd.cu (their headers say what bounds them and what the design
leaves open), built by ops/_build.py and called through ctypes on PyTorch's
current stream.

`cspn2d_cuda` is the wrapper.  A tensor on the CPU goes to the kernels'
plain version (ops/cspn_ref.py, autograd-native) because it lies on the
CPU; a CUDA tensor goes to the kernels or raises, forward and backward.
There is no fallback between the two.

`launches` counts the forward kernel's runs (one per forward: one `prep`
launch plus `steps` `step` launches on the card); `bwd_launches` counts the
backward kernel's runs (one per backward: prep, `steps - 1` replay steps,
`steps` reverse steps and two epilogue launches).
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn import _reference, _round_io

launches = 0
bwd_launches = 0


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


def _launch_bwd(guid_cf, blur, sparse, ct, steps: int, norm_type: str):
    """Run the backward kernel on checked f32 inputs and the cotangent `ct`
    of the output; returns (d guidance [N,8,H,W], d blur [N,H,W])."""
    global bwd_launches
    from cspn_tpu_torch.ops import _build

    if ct.dtype != torch.float32 or ct.device != blur.device or ct.shape != blur.shape:
        raise ValueError(f"the cotangent must be float32 {tuple(blur.shape)} on {blur.device}, "
                         f"got {ct.dtype} {tuple(ct.shape)} on {ct.device}")
    lib = _build.load("cspn2d_bwd")
    n, _, h, w = guid_cf.shape
    dguid = torch.empty_like(guid_cf)
    dblur = torch.empty_like(blur)
    gates, gbar = torch.empty_like(guid_cf), torch.empty_like(guid_cf)
    base, bbar = torch.empty_like(blur), torch.empty_like(blur)
    v = blur.new_empty((2, n, h, w))
    states = blur.new_empty((max(int(steps) - 1, 0), n, h, w))  # x_1 .. x_{T-1}
    with torch.cuda.device(guid_cf.device):
        err = lib.cspn2d_bwd_f32(
            guid_cf.data_ptr(), blur.data_ptr(),
            None if sparse is None else sparse.data_ptr(), ct.data_ptr(),
            dguid.data_ptr(), dblur.data_ptr(), gates.data_ptr(), gbar.data_ptr(),
            base.data_ptr(), bbar.data_ptr(), v.data_ptr(), states.data_ptr(),
            n, h, w, int(steps), int(norm_type == "8sum_abs"),
            torch.cuda.current_stream(guid_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_bwd_f32 launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dguid, dblur


class _Cspn2dFwd(torch.autograd.Function):
    """Forward and backward are the CUDA kernels.  As the JAX custom VJP
    (cspn_pallas.py:_cspn2d_fwd/_cspn2d_bwd), the forward rounds its inputs
    through `io_dtype` and saves them unrounded: the backward is the exact
    adjoint of the f32 function at the f32 inputs.  The sparse map enters
    only through sign(), so its gradient is None (zero)."""

    @staticmethod
    def forward(ctx, guid_cf, blur, sparse, steps, norm_type, io_dtype):
        ctx.save_for_backward(guid_cf, blur, sparse)
        ctx.steps, ctx.norm_type = steps, norm_type
        g, b, s = _round_io(guid_cf, blur, sparse, io_dtype)
        return _launch(g, b, s, steps, norm_type)

    @staticmethod
    def backward(ctx, grad_out):
        guid_cf, blur, sparse = ctx.saved_tensors
        dguid, dblur = _launch_bwd(guid_cf, blur, sparse, grad_out.contiguous(),
                                   ctx.steps, ctx.norm_type)
        return dguid, dblur, None, None, None, None


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
            they are rounded through it, then the f32 kernel runs; the
            backward runs on the unrounded inputs.
    Returns [N, H, W] float32, differentiable in guidance and blur_depth.
    """
    if guidance.device.type == "cpu":
        return _reference(guidance, blur_depth, sparse_depth, steps, norm_type,
                          channel_first, io_dtype)
    g_cf = (guidance if channel_first else guidance.movedim(-1, 1)).contiguous()
    _check_inputs(g_cf, blur_depth, sparse_depth, norm_type)
    return _Cspn2dFwd.apply(g_cf, blur_depth, sparse_depth, steps, norm_type, io_dtype)
