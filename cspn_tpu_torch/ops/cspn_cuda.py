"""Hopper kernels for the 2D CSPN forward and backward (counterpart of
cspn_tpu/ops/cspn_pallas.py:cspn2d_pallas and its _fwd_kernel and
_bwd_kernel, and of cspn2d_tiled and its _fwd_dma_kernel).

The kernels are hand-written CUDA C++ in csrc/cspn2d_fwd.cu (one launch
per step), csrc/cspn2d_tiled.cu (8 steps per launch on halo-extended
tiles) and csrc/cspn2d_bwd.cu (their headers say what bounds them and what
the design leaves open), built by ops/_build.py and called through ctypes
on PyTorch's current stream.

`cspn2d_cuda` is the wrapper.  A tensor on the CPU goes to the kernels'
plain version (ops/cspn_ref.py, autograd-native) because it lies on the
CPU; a CUDA tensor goes to the kernels or raises, forward and backward.
There is no fallback between the two.  Both forward kernels compute the
same function, value for value, and the backward kernel is its exact
adjoint at every size.  `use_tiled` picks the forward: the tiled kernel
for a forward that no backward follows, the per-step kernel, keeping its
states for the backward, for one that `cspn2d_bwd` follows.

`launches` counts the per-step forward's runs (one per forward: one
`prep` launch plus `steps` `step` launches on the card); `tiled_launches`
counts the tiled forward's runs (one per forward: prep plus
ceil(steps / 8) tile launches); `bwd_launches` counts the backward
kernel's runs (one per backward: `steps` reverse steps and two epilogue
launches, after a prep and `steps - 1` replay steps unless the forward
kept its states).
"""

from __future__ import annotations

import dataclasses

import torch

from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn import _reference, _round_io

launches = 0
tiled_launches = 0
bwd_launches = 0

TILE, HALO = 32, 8  # csrc/cspn2d_tile.cuh: kTile (interior side), kHalo (steps per launch)


def use_tiled(for_backward: bool) -> bool:
    """The 2D forward's kernel, set from both kernels' times on an H100
    (chip_smoke.py phase 3; PERF.md).  The tiled kernel is 1.4-2.9x
    faster than the per-step one at every shape of the paths (NYU b1-b16,
    KITTI b1-b4, 24 steps), so every forward that no backward follows runs
    it.  A forward that `cspn2d_bwd` follows runs the per-step kernel,
    which writes its states x_1..x_{T-1} and folded gates on the way: the
    backward then skips its prep and its T-1 replay steps, which cost more
    than the per-step forward's lag behind the tiled one."""
    return not for_backward


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tiled kernel's schedule for one h x w map: `grid` (rows, columns)
    tiles of `tile` x `tile` interiors, each computed on its interior
    extended by `halo` on every side, in launches of `launch_steps` steps
    (each at most `halo`)."""

    h: int
    w: int
    tile: int
    halo: int
    grid: tuple[int, int]
    launch_steps: tuple[int, ...]

    def interior(self, ty: int, tx: int) -> tuple[int, int, int, int]:
        """Rows [r0, r1) and columns [c0, c1) of the image tile (ty, tx) writes."""
        t = self.tile
        return ty * t, min((ty + 1) * t, self.h), tx * t, min((tx + 1) * t, self.w)

    def extended(self, ty: int, tx: int) -> tuple[int, int, int, int]:
        """Rows [r0, r1) and columns [c0, c1) tile (ty, tx) computes on; the
        part outside the image is held at 0."""
        t, k = self.tile, self.halo
        return ty * t - k, (ty + 1) * t + k, tx * t - k, (tx + 1) * t + k


def plan_tiles(h: int, w: int, steps: int, k: int = HALO, tile: int = TILE) -> TilePlan:
    """The tile grid and launch schedule of `steps` steps on an h x w map
    (ragged last tiles included: the kernel masks them)."""
    if min(h, w, k, tile) < 1 or steps < 0:
        raise ValueError(f"bad tile plan arguments h={h} w={w} steps={steps} k={k} tile={tile}")
    full, rest = divmod(steps, k)
    return TilePlan(h, w, tile, k, (-(-h // tile), -(-w // tile)),
                    (k,) * full + ((rest,) if rest else ()))


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


def _launch(guid_cf, blur, sparse, steps: int, norm_type: str, keep_states: bool = False):
    """Run the per-step kernel on already checked inputs; returns [N, H, W]
    f32, or with `keep_states` (out, folded gates [N,8,H,W], states
    x_1..x_{T-1} [T-1,N,H,W]) for `_launch_bwd`."""
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("cspn2d_fwd")
    n, _, h, w = guid_cf.shape
    out = torch.empty_like(blur)
    gates = torch.empty_like(guid_cf)
    base = torch.empty_like(blur)
    if keep_states:
        x_scratch, states = None, blur.new_empty((max(int(steps) - 1, 0), n, h, w))
    else:
        x_scratch, states = torch.empty_like(blur), None
    with torch.cuda.device(guid_cf.device):  # the runtime launches on the current device
        err = lib.cspn2d_fwd_f32(
            guid_cf.data_ptr(), blur.data_ptr(),
            None if sparse is None else sparse.data_ptr(),
            out.data_ptr(), gates.data_ptr(), base.data_ptr(),
            None if x_scratch is None else x_scratch.data_ptr(),
            None if states is None else states.data_ptr(),
            n, h, w, int(steps), int(norm_type == "8sum_abs"),
            torch.cuda.current_stream(guid_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_fwd_f32 launch failed: cudaError_t {err}")
    launches += 1
    return (out, gates, states) if keep_states else out


def _launch_tiled(guid_cf, blur, sparse, steps: int, norm_type: str) -> torch.Tensor:
    """Run the tiled forward on already checked inputs; returns [N, H, W] f32."""
    global tiled_launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("cspn2d_tiled")
    n, _, h, w = guid_cf.shape
    out = torch.empty_like(blur)
    gates = torch.empty_like(guid_cf)
    base = torch.empty_like(blur)
    x_scratch = torch.empty_like(blur)
    with torch.cuda.device(guid_cf.device):
        err = lib.cspn2d_tiled_f32(
            guid_cf.data_ptr(), blur.data_ptr(),
            None if sparse is None else sparse.data_ptr(),
            out.data_ptr(), gates.data_ptr(), base.data_ptr(), x_scratch.data_ptr(),
            n, h, w, int(steps), int(norm_type == "8sum_abs"), TILE, HALO,
            torch.cuda.current_stream(guid_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_tiled_f32 launch failed: cudaError_t {err}")
    tiled_launches += 1
    return out


def _launch_bwd(guid_cf, blur, sparse, ct, steps: int, norm_type: str, kept=None):
    """Run the backward kernel on checked f32 inputs and the cotangent `ct`
    of the output; returns (d guidance [N,8,H,W], d blur [N,H,W]).  `kept`
    is the (folded gates, states) a forward on the same inputs kept
    (`_launch(..., keep_states=True)`); without it the kernel recomputes
    them (prep and replay)."""
    global bwd_launches
    from cspn_tpu_torch.ops import _build

    if ct.dtype != torch.float32 or ct.device != blur.device or ct.shape != blur.shape:
        raise ValueError(f"the cotangent must be float32 {tuple(blur.shape)} on {blur.device}, "
                         f"got {ct.dtype} {tuple(ct.shape)} on {ct.device}")
    lib = _build.load("cspn2d_bwd")
    n, _, h, w = guid_cf.shape
    dguid = torch.empty_like(guid_cf)
    dblur = torch.empty_like(blur)
    gbar, bbar = torch.empty_like(guid_cf), torch.empty_like(blur)
    v = blur.new_empty((2, n, h, w))
    if kept is None:
        gates, base = torch.empty_like(guid_cf), torch.empty_like(blur)
        states = blur.new_empty((max(int(steps) - 1, 0), n, h, w))  # x_1 .. x_{T-1}
    else:
        (gates, states), base = kept, None
    with torch.cuda.device(guid_cf.device):
        err = lib.cspn2d_bwd_f32(
            guid_cf.data_ptr(), blur.data_ptr(),
            None if sparse is None else sparse.data_ptr(), ct.data_ptr(),
            dguid.data_ptr(), dblur.data_ptr(), gates.data_ptr(), gbar.data_ptr(),
            None if base is None else base.data_ptr(), bbar.data_ptr(), v.data_ptr(),
            states.data_ptr(), n, h, w, int(steps), int(norm_type == "8sum_abs"),
            int(kept is not None), torch.cuda.current_stream(guid_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_bwd_f32 launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dguid, dblur


class _Cspn2dFwd(torch.autograd.Function):
    """The forward that `cspn2d_bwd` follows: the per-step kernel, keeping
    its folded gates and states for the backward kernel.  As the JAX custom
    VJP (cspn_pallas.py:_cspn2d_fwd/_cspn2d_bwd), the forward rounds its
    inputs through `io_dtype` and saves them unrounded: the backward is the
    exact adjoint of the f32 function at the f32 inputs, so the states of
    rounded inputs are not kept and the backward recomputes them.  The
    sparse map enters only through sign(), so its gradient is None (zero)."""

    @staticmethod
    def forward(ctx, guid_cf, blur, sparse, steps, norm_type, io_dtype):
        g, b, s = _round_io(guid_cf, blur, sparse, io_dtype)
        if g is guid_cf:
            out, gates, states = _launch(g, b, s, steps, norm_type, keep_states=True)
        else:
            out, gates, states = _launch(g, b, s, steps, norm_type), None, None
        ctx.save_for_backward(guid_cf, blur, sparse, gates, states)
        ctx.steps, ctx.norm_type = steps, norm_type
        return out

    @staticmethod
    def backward(ctx, grad_out):
        guid_cf, blur, sparse, gates, states = ctx.saved_tensors
        dguid, dblur = _launch_bwd(guid_cf, blur, sparse, grad_out.contiguous(), ctx.steps,
                                   ctx.norm_type, None if states is None else (gates, states))
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
    for_backward = torch.is_grad_enabled() and (g_cf.requires_grad or blur_depth.requires_grad)
    if use_tiled(for_backward):
        return _launch_tiled(*_round_io(g_cf, blur_depth, sparse_depth, io_dtype), steps, norm_type)
    return _Cspn2dFwd.apply(g_cf, blur_depth, sparse_depth, steps, norm_type, io_dtype)
