"""Hopper kernels for the spatially sharded 2D CSPN's local segment
(counterpart of cspn_tpu/ops/cspn_pallas.py:cspn2d_halo_segment and its
_halo_seg_kernel and _halo_seg_bwd_kernel).

The kernels are hand-written CUDA C++ in csrc/cspn2d_halo_seg.cu (K steps
on the halo-extended block as the tiled forward's image, 8 steps per
launch) and csrc/cspn2d_halo_seg_bwd.cu (the 2D CSPN backward's two
pieces on the block: a replay by the column march keeping its states,
with keep folded into the gates at load, then reverse tiles, 12 steps a
launch each, and a keep epilogue); their headers say what bounds them and
what the design leaves open.  ops/_build.py builds them and they run through ctypes on
PyTorch's current stream.

`cspn2d_halo_segment` is the wrapper.  A tensor on the CPU goes to the
kernels' plain version (ops/cspn_ref.py:halo_segment_reference,
autograd-native) because it lies on the CPU; a CUDA tensor goes to the
kernels or raises, forward and backward.  There is no fallback between
the two, and none by size (the JAX package falls back to autodiff when
the block is past its VMEM budget, cspn_pallas.py:601-618).

`launches` counts the forward kernel's runs (one per segment:
ceil(k / 8) tile launches on the card); `bwd_launches` counts the
backward kernel's runs (one per segment: `cuda_launches` says how many
CUDA launches each makes).
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn_cuda import HALO as MARCH_HALO

# csrc/cspn2d_tile.cuh, the tile stencil of this kernel and of paddle2d.cu
# (ops/cspn_paddle2d_cuda.py): kTile (interior side), kHalo (steps per launch)
# of the forward; the backward runs csrc/cspn2d_march.cuh's tiles, MARCH_HALO
# steps a launch
TILE, HALO = 32, 8

launches = 0
bwd_launches = 0


def cuda_launches(k_steps: int, with_keep: bool) -> tuple[int, int]:
    """The CUDA launches of one segment (k_steps > 0): the forward's tile
    launches, and the backward's replay of k - 1 steps (ceil((k - 1) / 12)
    launches; with keep at least one, which writes the folded gates), its
    ceil(k / 12) reverse tiles and, with keep, its epilogue."""
    replay = -(-(k_steps - 1) // MARCH_HALO)
    if with_keep:
        replay = max(replay, 1)
    return -(-k_steps // HALO), replay + -(-k_steps // MARCH_HALO) + int(with_keep)


def _check_inputs(gates_cf, base, keep, x):
    if gates_cf.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {gates_cf.device}")
    if gates_cf.ndim != 4 or gates_cf.shape[1] != 8:
        raise ValueError(f"gates must be [n,8,He,W], got {tuple(gates_cf.shape)}")
    n, _, h, w = gates_cf.shape
    if n > 65535:
        raise ValueError(f"{n} blocks exceed the kernel's grid limit 65535")
    for name, t in (("gates", gates_cf), ("base", base), ("keep", keep), ("x", x)):
        if t is None:
            continue
        if t.device != gates_cf.device:
            raise ValueError(f"{name} on {t.device}, gates on {gates_cf.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not gates_cf and tuple(t.shape) != (n, h, w):
            raise ValueError(f"{name} must be [{n},{h},{w}], got {tuple(t.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(gates_cf, base, keep, x, k_steps: int) -> torch.Tensor:
    """Run the forward kernel on checked inputs; returns [n, He, W] f32."""
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("cspn2d_halo_seg")
    n, _, h, w = gates_cf.shape
    out = torch.empty_like(x)
    x_scratch = torch.empty_like(x)
    with torch.cuda.device(gates_cf.device):  # the runtime launches on the current device
        err = lib.cspn2d_halo_seg_f32(
            gates_cf.data_ptr(), base.data_ptr(), _ptr(keep), x.data_ptr(), out.data_ptr(),
            x_scratch.data_ptr(), n, h, w, int(k_steps), TILE, HALO,
            torch.cuda.current_stream(gates_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_halo_seg_f32 launch failed: cudaError_t {err}")
    launches += 1
    return out


def _launch_bwd(gates_cf, base, keep, x, ct, k_steps: int):
    """Run the backward kernel on checked inputs and the cotangent `ct` of
    the output; returns (d gates [n,8,He,W], d base, d keep or None, d x)."""
    global bwd_launches
    from cspn_tpu_torch.ops import _build

    if ct.dtype != torch.float32 or ct.device != x.device or ct.shape != x.shape:
        raise ValueError(f"the cotangent must be float32 {tuple(x.shape)} on {x.device}, "
                         f"got {ct.dtype} {tuple(ct.shape)} on {ct.device}")
    lib = _build.load("cspn2d_halo_seg_bwd")
    n, _, h, w = gates_cf.shape
    dgates, dbase, dx = torch.empty_like(gates_cf), torch.empty_like(x), torch.empty_like(x)
    dkeep = None if keep is None else torch.empty_like(x)
    folded = None if keep is None else torch.empty_like(gates_cf)
    v_scratch = torch.empty_like(x)
    states = x.new_empty((max(int(k_steps) - 1, 0), n, h, w))  # x_1 .. x_{K-1}
    with torch.cuda.device(gates_cf.device):
        err = lib.cspn2d_halo_seg_bwd_f32(
            gates_cf.data_ptr(), base.data_ptr(), _ptr(keep), x.data_ptr(), ct.data_ptr(),
            dgates.data_ptr(), dbase.data_ptr(), _ptr(dkeep), dx.data_ptr(), _ptr(folded),
            v_scratch.data_ptr(), states.data_ptr(), n, h, w, int(k_steps),
            torch.cuda.current_stream(gates_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_halo_seg_bwd_f32 launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dgates, dbase, dkeep, dx


class _HaloSegment(torch.autograd.Function):
    """Forward and backward are the CUDA kernels; the backward replays the
    segment from the inputs the forward saved (the exact adjoint)."""

    @staticmethod
    def forward(ctx, gates_cf, base, keep, x, k_steps):
        ctx.save_for_backward(gates_cf, base, keep, x)
        ctx.k_steps = k_steps
        return _launch(gates_cf, base, keep, x, k_steps)

    @staticmethod
    def backward(ctx, grad_out):
        gates_cf, base, keep, x = ctx.saved_tensors
        dg, db, dk, dx = _launch_bwd(gates_cf, base, keep, x, grad_out.contiguous(), ctx.k_steps)
        return dg, db, dk, dx, None


def cspn2d_halo_segment(
    gates_cf: torch.Tensor,
    base: torch.Tensor,
    keep: torch.Tensor | None,
    x: torch.Tensor,
    k_steps: int,
) -> torch.Tensor:
    """`k_steps` propagation steps on one halo-extended row block (see
    cspn_ref.halo_segment_reference for the function).

    Args:
        gates_cf: [n, 8, He, W] normalized gather-form gates.
        base: [n, He, W], keep*center*x0 + mask*x0 (center*x0 without sparse).
        keep: [n, He, W] 1 - mask, or None.
        x: [n, He, W] running state.
    Returns [n, He, W], differentiable in every tensor argument.
    """
    if gates_cf.device.type == "cpu":
        return cspn_ref.halo_segment_reference(gates_cf, base, keep, x, k_steps)
    _check_inputs(gates_cf, base, keep, x)
    return _HaloSegment.apply(gates_cf, base, keep, x, k_steps)
