"""Hopper kernels for the 2D CSPN forward and backward (counterpart of
cspn_tpu/ops/cspn_pallas.py:cspn2d_pallas and its _fwd_kernel and
_bwd_kernel, and of cspn2d_tiled and its _fwd_dma_kernel).

The kernels are hand-written CUDA C++ on one column march
(csrc/cspn2d_march.cuh: K steps per launch on halo-extended tiles, the
first launch folding the gates): csrc/cspn2d_fwd.cu (the forward that
also stores its states x_1..x_{T-1} and folded gates), csrc/cspn2d_tiled.cu
(the forward that stores only its output) and csrc/cspn2d_bwd.cu (the
adjoint as reverse tiles of K steps on the same tiles, then one epilogue
launch); their headers say what bounds them and what the design leaves
open.  ops/_build.py builds them; they run through ctypes on
PyTorch's current stream.

`cspn2d_cuda` is the wrapper.  A tensor on the CPU goes to the kernels'
plain version (ops/cspn_ref.py, autograd-native) because it lies on the
CPU; a CUDA tensor goes to the kernels or raises, forward and backward.
There is no fallback between the two.

Inputs may be float32 or bf16, each on its own, as
cspn_pallas.py:_fwd_kernel reads bf16 guidance, blur and sparse under
`io_dtype` bfloat16 (:252-255).  The tiled kernel reads them as they lie
and upcasts bf16 at first use; with `io_dtype` bfloat16 it rounds float32
inputs to bf16 in registers as it loads them (`io_codes`), so no cast runs
before it.  The forward that keeps its states and the backward read
float32: a training forward on bf16 inputs without I/O rounding upcasts
them first (exact), and under bf16 I/O the forward runs the tiled kernel
and the backward replays from the unrounded inputs, upcast.  Both forward kernels compute the
same function, value for value, and the backward kernel is its exact
adjoint at every size.  `use_tiled` picks the forward: the tiled kernel
for a forward that no backward follows, the one keeping its states for
one that `cspn2d_bwd` follows.

The tiled forward is also the torch custom op `cspn_tpu_torch::cspn2d_tiled`
(`cspn2d_tiled`): its CUDA implementation checks the inputs and launches
the kernel, its CPU one is the plain version, and its fake one gives the
output's shape, so `torch.export` records the op as one node and an
exported program launches the kernel (export.py).  The route that no
backward follows calls it; the training route stays the `_Cspn2dFwd`
autograd.Function over cspn2d_fwd and cspn2d_bwd.

`launches` counts the states forward's runs (cspn2d_fwd), `tiled_launches`
the tiled forward's, `bwd_launches` the backward kernel's: one per call
each, counted where the kernel is launched, so an exported program's runs
count too.  `cuda_launches_per_call` gives the CUDA launches one call makes.
"""

from __future__ import annotations

import dataclasses

import torch

from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn import _io_dtype, _reference, _upcast

launches = 0
tiled_launches = 0
bwd_launches = 0

# csrc/cspn2d_march.cuh: the tiles of both forwards and of cspn2d_bwd.cu's
# reverse sweep are kExt x kExt extended, an interior of kTile and kHalo
# steps a launch (K = 12, chosen by timing K = 8 and 12; PERF.md)
EXT, HALO = 64, 12
TILE = EXT - 2 * HALO


def cuda_launches_per_call(steps: int) -> dict[str, int]:
    """The CUDA kernel launches of one call of each kernel at `steps`
    steps (copies and memsets not counted): the forward keeping its states
    and the tiled forward (ceil(steps / K) tiles each), and the backward on
    the forward's kept states (ceil(steps / K) reverse tiles and the
    epilogue) or replaying them first (the states forward over steps - 1
    steps: ceil((steps - 1) / K) launches, one that only folds the gates at
    steps = 1)."""
    if steps <= 0:
        return {"cspn2d_fwd": 0, "cspn2d_tiled": 0, "cspn2d_bwd_kept": 0, "cspn2d_bwd_replay": 0}
    tiles = -(-steps // HALO)
    replay = max(-(-(steps - 1) // HALO), 1)
    return {"cspn2d_fwd": tiles, "cspn2d_tiled": tiles, "cspn2d_bwd_kept": tiles + 1,
            "cspn2d_bwd_replay": replay + tiles + 1}


def use_tiled(for_backward: bool) -> bool:
    """The 2D forward's kernel.  Both forwards are the same column march
    (csrc/cspn2d_march.cuh) and give the same values; a forward that no
    backward follows runs the tiled kernel, which stores only its output.
    A forward that `cspn2d_bwd` follows runs cspn2d_fwd, which also stores
    its states x_1..x_{T-1} and folded gates: the backward then reads them
    instead of replaying them, which costs more than the stores (chip_smoke.py
    phase 3: time_fwd_routes, train_tiled against train_kept; PERF.md)."""
    return not for_backward


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tile kernels' schedule for one h x w map: `grid` (rows, columns)
    tiles of `tile` x `tile` interiors, each computed on its interior
    extended by `halo` on every side, in launches of `launch_steps` steps
    (each at most `halo`; the forward runs them in order, the backward's
    reverse tiles in reverse: the ragged launch first)."""

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


# csrc/cspn2d_common.cuh:IoCode: how the tiled kernel's first launch reads
# an input
IO_F32, IO_F32_ROUND, IO_BF16 = 0, 1, 2
INPUT_DTYPES = (torch.float32, torch.bfloat16)


def io_codes(guid_cf, blur, sparse, io_dtype=None) -> tuple[int, int, int]:
    """Each input's IoCode: bf16 read as it is (upcast), float32 read as it
    is or, with `io_dtype` bfloat16, rounded to bf16 in registers.  The
    kernel rounds through bf16 only: another `io_dtype` raises."""
    dt = _io_dtype(io_dtype)
    if dt not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"the 2D CSPN kernels' I/O dtype is float32 or bfloat16, got {dt}")
    f32 = IO_F32 if dt in (None, torch.float32) else IO_F32_ROUND
    return tuple(IO_BF16 if t is not None and t.dtype == torch.bfloat16 else f32
                 for t in (guid_cf, blur, sparse))


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
        if t.dtype not in INPUT_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not guid_cf and tuple(t.shape) != (n, h, w):
            raise ValueError(f"{name} must be [{n},{h},{w}], got {tuple(t.shape)}")


def _launch(guid_cf, blur, sparse, steps: int, norm_type: str):
    """Run the forward that keeps its states (cspn2d_fwd) on already
    checked float32 inputs; returns (out [N,H,W] f32, folded gates [N,8,H,W],
    states x_1..x_{T-1} [T-1,N,H,W]), the last two for `_launch_bwd`."""
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("cspn2d_fwd")
    n, _, h, w = guid_cf.shape
    out = torch.empty_like(blur)
    gates = torch.empty_like(guid_cf)
    base = torch.empty_like(blur)  # the first launch's folded base, for the later ones
    states = blur.new_empty((max(int(steps) - 1, 0), n, h, w))
    with torch.cuda.device(guid_cf.device):  # the runtime launches on the current device
        err = lib.cspn2d_fwd_f32(
            guid_cf.data_ptr(), blur.data_ptr(),
            None if sparse is None else sparse.data_ptr(),
            out.data_ptr(), gates.data_ptr(), base.data_ptr(), states.data_ptr(),
            n, h, w, int(steps), int(norm_type == "8sum_abs"),
            torch.cuda.current_stream(guid_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_fwd_f32 launch failed: cudaError_t {err}")
    launches += 1
    return out, gates, states


def _launch_tiled(guid_cf, blur, sparse, steps: int, norm_type: str,
                  io_dtype=None) -> torch.Tensor:
    """Run the tiled forward on already checked inputs, each float32 or
    bf16, read as `io_codes` says (`cspn2d_tiled_f32` where all three are
    float32 read as they are, else `cspn2d_tiled_io`); returns [N, H, W]
    f32."""
    global tiled_launches
    from cspn_tpu_torch.ops import _build

    codes = io_codes(guid_cf, blur, sparse, io_dtype)
    lib = _build.load("cspn2d_tiled")
    n, _, h, w = guid_cf.shape
    f32 = dict(dtype=torch.float32, device=blur.device)
    out = torch.empty((n, h, w), **f32)
    # the first launch's keep * gate_d and base, for the later ones
    gates, base = torch.empty((n, 8, h, w), **f32), torch.empty((n, h, w), **f32)
    x_scratch = torch.empty((n, h, w), **f32)
    inputs = (guid_cf.data_ptr(), blur.data_ptr(), None if sparse is None else sparse.data_ptr())
    rest = (out.data_ptr(), gates.data_ptr(), base.data_ptr(), x_scratch.data_ptr(),
            n, h, w, int(steps), int(norm_type == "8sum_abs"))
    plain_f32 = codes == (IO_F32,) * 3
    with torch.cuda.device(guid_cf.device):
        stream = torch.cuda.current_stream(guid_cf.device).cuda_stream
        if plain_f32:
            err = lib.cspn2d_tiled_f32(*inputs, *rest, stream)
        else:
            err = lib.cspn2d_tiled_io(*inputs, *codes, *rest, stream)
    if err != 0:
        fn = "cspn2d_tiled_f32" if plain_f32 else "cspn2d_tiled_io"
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err}")
    tiled_launches += 1
    return out


def _launch_bwd(guid_cf, blur, sparse, ct, steps: int, norm_type: str, kept=None):
    """Run the backward kernel on checked float32 inputs and the cotangent `ct`
    of the output; returns (d guidance [N,8,H,W], d blur [N,H,W]).  `kept` is the (folded gates,
    states) a forward on the same inputs kept (`_launch`); without it the kernel recomputes them (the states
    forward over steps - 1 steps)."""
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
            int(kept is not None),
            torch.cuda.current_stream(guid_cf.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn2d_bwd_f32 launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dguid, dblur


@torch.library.custom_op("cspn_tpu_torch::cspn2d_tiled", mutates_args=(), device_types="cuda")
def cspn2d_tiled(guid_cf: torch.Tensor, blur: torch.Tensor, sparse: torch.Tensor | None,
                 steps: int, norm_type: str, io_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The tiled forward (csrc/cspn2d_tiled.cu) as a torch op: guidance
    [N, 8, H, W], blur and sparse [N, H, W], each float32 or bf16, read as
    they are (`io_dtype` bfloat16: float32 ones rounded to bf16 in the
    kernel) -> [N, H, W] float32, so an exported graph hands bf16 heads to
    the one node.  The checks run here, on real tensors, so that tracing
    (FakeTensors, a symbolic batch) reaches none of them; the inputs are
    made contiguous here too, since a traced graph's strides are its fake
    tensors' and need not be the real ones (ops/d2s.py:d2s_op)."""
    guid_cf, blur = guid_cf.contiguous(), blur.contiguous()
    sparse = None if sparse is None else sparse.contiguous()
    _check_inputs(guid_cf, blur, sparse, norm_type)
    return _launch_tiled(guid_cf, blur, sparse, steps, norm_type, io_dtype)


@cspn2d_tiled.register_kernel("cpu")
def _cspn2d_tiled_plain(guid_cf, blur, sparse, steps, norm_type, io_dtype=None):
    # the plain version on the rounded and upcast inputs; a copy: at 0 steps
    # it gives `blur` itself, and an op's output may not alias an input
    return _reference(guid_cf, blur, sparse, steps, norm_type, True, io_dtype).clone()


@cspn2d_tiled.register_fake
def _(guid_cf, blur, sparse, steps, norm_type, io_dtype=None):
    return torch.empty_like(blur, dtype=torch.float32)


class _Cspn2dFwd(torch.autograd.Function):
    """The forward that `cspn2d_bwd` follows: cspn2d_fwd, keeping its folded
    gates and states for the backward kernel, on float32 inputs (bf16 ones
    upcast, exact).  As the JAX custom VJP (cspn_pallas.py:_cspn2d_fwd /
    _cspn2d_bwd), under `io_dtype` bfloat16 the forward reads its inputs
    rounded and saves them unrounded: the backward is the exact adjoint of
    the f32 function at the unrounded inputs, so that forward runs the
    tiled kernel (which rounds them as it loads them), keeps nothing, and
    the backward replays the states from the unrounded inputs, upcast.
    The gradients come back in the inputs' dtypes.  The sparse map enters
    only through sign(), so its gradient is None (zero)."""

    @staticmethod
    def forward(ctx, guid_cf, blur, sparse, steps, norm_type, io_dtype):
        if _io_dtype(io_dtype) in (None, torch.float32):
            g, b, s = _upcast(guid_cf, blur, sparse)
            out, gates, states = _launch(g, b, s, steps, norm_type)
        else:
            out = _launch_tiled(guid_cf, blur, sparse, steps, norm_type, io_dtype)
            (g, b, s), gates, states = (guid_cf, blur, sparse), None, None
        ctx.save_for_backward(g, b, s, gates, states)
        ctx.steps, ctx.norm_type = steps, norm_type
        ctx.dtypes = guid_cf.dtype, blur.dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        guid_cf, blur, sparse, gates, states = ctx.saved_tensors
        dguid, dblur = _launch_bwd(*_upcast(guid_cf, blur, sparse), grad_out.contiguous(),
                                   ctx.steps, ctx.norm_type,
                                   None if states is None else (gates, states))
        return dguid.to(ctx.dtypes[0]), dblur.to(ctx.dtypes[1]), None, None, None, None


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
        Each may be float32 or bfloat16 (read as its upcast).
        io_dtype: the I/O dtype, None (float32) or torch.bfloat16: the
            kernel rounds float32 inputs to bf16 as it loads them (the
            plain version on the CPU rounds them first); the backward runs
            on the unrounded inputs.
    Returns [N, H, W] float32, differentiable in guidance and blur_depth
    (gradients in their dtypes).
    """
    if guidance.device.type == "cpu":
        return _reference(guidance, blur_depth, sparse_depth, steps, norm_type,
                          channel_first, io_dtype)
    g_cf = (guidance if channel_first else guidance.movedim(-1, 1)).contiguous()
    for_backward = torch.is_grad_enabled() and (g_cf.requires_grad or blur_depth.requires_grad)
    if use_tiled(for_backward):
        return torch.ops.cspn_tpu_torch.cspn2d_tiled(g_cf, blur_depth, sparse_depth, steps,
                                                     norm_type, _io_dtype(io_dtype))
    _check_inputs(g_cf, blur_depth, sparse_depth, norm_type)
    return _Cspn2dFwd.apply(g_cf, blur_depth, sparse_depth, steps, norm_type, io_dtype)
