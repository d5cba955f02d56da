"""Hopper kernels for the 3D CSPN forward and backward (counterpart of
cspn_tpu/ops/cspn3d_pallas.py: affinity_propagate3d_fused and its
_seg_kernel, affinity_propagate3d_fused_bwd and its _bwd3_kernel, wired
together by cspn_pallas.py:_cspn3d_fused_vjp).

The kernels are hand-written CUDA C++ in csrc/cspn3d_fwd.cu and
csrc/cspn3d_bwd.cu around the persistent sweep of csrc/cspn3d_common.cuh
(their headers say what bounds them and what the design leaves open),
built by ops/_build.py and called through ctypes on PyTorch's current
stream.  They run `steps` propagation steps on fixed normalized gates; the
abs and per-group sum-normalization around them stay plain PyTorch
(autograd gives their quotient-rule backward), as JAX leaves them to XLA
(cspn3d_pallas.py:558-564, cspn_pallas.py:1520-1536).

Gate dtype (`gate_dtype`, cspn3d_pallas.py:181-191,448-491): the kernels
read the gates as float32 or as bf16 (the normalized float32 gates rounded
once, to nearest even; the JAX TPU route's default), and widen them at
use; states, sums and the centre weight 1 - sum_d w_d (from the gates as
read) are float32 either way.  The backward runs the adjoint with the same
rounded gates and its gate cotangents come from the float32 states; they
pass to the unrounded gates unchanged.  The plain version of the bf16
route (`propagate3d_reference`) is the float32 plain sweep on the gates
rounded through torch.bfloat16.

`propagate3d` is the kernels' wrapper.  A tensor on the CPU goes to their
plain version (ops/cspn_ref.py:propagate_nd_reference, autograd-native)
because it lies on the CPU; a CUDA tensor goes to the kernels or raises,
forward and backward.  There is no fallback between the two.  A forward
that a backward will follow keeps its states x_1..x_{T-1} for the
backward kernel, which has no replay; any other forward writes its states
into two buffers in turn.

`launches` counts the forward kernel's runs and `bwd_launches` the
backward kernel's, one per wrapper call; `cuda_launches_per_call` says how
many CUDA launches each call should make (chip_smoke.py and the card-only
tests count them with torch.profiler and hold them to it).  `plan_volume`
is the partition the sweep runs: which voxels each block owns and where
their gates live.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cspn_tpu_torch.ops import cspn_ref

N_GATES = 26
GATE_DTYPES = (torch.float32, torch.bfloat16)
SWEEP_THREADS = 768  # csrc/cspn3d_common.cuh: kSweepThreads
# the gate planes in shared memory the sweep is built for (CSPN3D_FOR_SMEM_PLANES)
SMEM_PLANES = tuple(range(26, -1, -2))
SLAB = 4  # kSlab: z-planes a brick spans
MAX_VOXELS = 1 << 31  # per volume: the sweep's voxel indices are ints (cspn3d_common.cuh)

launches = 0
bwd_launches = 0

_limits: dict[int, tuple[int, int]] = {}


def cuda_launches_per_call(steps: int) -> tuple[int, int]:
    """CUDA kernel launches one forward and one backward call should make:
    the forward's persistent sweep; the backward's reverse sweep and its
    gate-cotangent pass.  At steps == 0 both are copies (and a memset)."""
    return (1, 2) if steps > 0 else (0, 0)


@dataclasses.dataclass(frozen=True)
class VolumePlan:
    """The persistent sweep's partition of one [d, h, w] volume into
    `slabs` x `parts` bricks, run by `blocks` blocks: brick b spans the
    z-planes [s*SLAB, (s+1)*SLAB) of slab s = b // parts and, in them, the
    columns (flattened y, x) [p*cols, (p+1)*cols) of part p = b % parts;
    block k runs bricks k, k + blocks, ...  With a brick a block, `n_smem`
    of its 26 gate planes sit in shared memory (beside the centre weight)
    and `n_l2` are read from L2 at each step; a plan with more bricks than
    blocks (`loops`) keeps nothing in shared memory and reads all 26.
    `gate_bytes` is the gates' element size (4 float32, 2 bf16)."""

    d: int
    hw: int
    slabs: int
    parts: int
    cols: int
    blocks: int
    n_smem: int
    n_l2: int
    gate_bytes: int = 4

    @property
    def bricks(self) -> int:
        return self.slabs * self.parts

    @property
    def loops(self) -> bool:
        return self.bricks > self.blocks

    @property
    def smem_bytes(self) -> int:
        return 0 if self.loops else 4 * slot_words(self.n_smem, self.gate_bytes) * SLAB * self.cols

    def owned(self, block: int) -> list[int]:
        """The flat voxel indices block `block` owns, brick by brick."""
        voxels = []
        for b in range(block, self.bricks, self.blocks):
            s, p = divmod(b, self.parts)
            cols = range(p * self.cols, min((p + 1) * self.cols, self.hw))
            voxels += [z * self.hw + c for z in range(s * SLAB, min((s + 1) * SLAB, self.d))
                       for c in cols]
        return voxels


def slot_words(n_smem: int, gate_bytes: int = 4) -> int:
    """The 4-byte words of shared memory the sweep gives one voxel
    (csrc/cspn3d_common.cuh:slot_words): its float32 centre weight and
    `n_smem` gates of `gate_bytes` (two bf16 a word), padded to an odd
    count so that a warp's 32 voxels hit 32 banks."""
    if gate_bytes == 4:
        return n_smem + 1  # n_smem is even
    return (1 + n_smem // 2) | 1


def plan_volume(d: int, h: int, w: int, sms: int, smem_bytes: int,
                gate_bytes: int = 4) -> VolumePlan:
    """The partition csrc/cspn3d_common.cuh:sweep runs for a [d, h, w]
    volume on a card with `sms` SMs and `smem_bytes` of shared memory per
    block: slabs of SLAB z-planes, each cut into as many parts of columns
    as the SMs allow, one block per SM.  A part takes at least a warp's
    columns and at most the columns whose centre weights fit shared
    memory; where that leaves more bricks than SMs (a volume over 4 x SMs
    deep, or one too wide), a block runs several and reads every gate from
    L2.  Else shared memory holds the brick's centre weight and the most
    gate planes of SMEM_PLANES that fit beside it (`slot_words` at
    `gate_bytes` a gate), L2 the rest."""
    hw = h * w
    voxels = d * hw
    if voxels <= 0:
        raise ValueError(f"empty volume {d}x{h}x{w}")
    if voxels >= MAX_VOXELS:
        raise ValueError(f"{voxels} voxels per volume exceed the 3D kernels' int indices")
    max_cols = smem_bytes // (4 * SLAB) // 32 * 32
    if max_cols < 32:
        raise ValueError(f"{smem_bytes} B of shared memory hold no warp's centre weights")
    slabs = -(-d // SLAB)
    cols = min(max(-(-hw // max(sms // slabs, 1)), min(hw, 32)), max_cols)
    parts = -(-hw // cols)
    words = smem_bytes // (4 * SLAB * cols) if slabs * parts <= sms else 1
    n_smem = max(n for n in SMEM_PLANES if slot_words(n, gate_bytes) <= words)
    return VolumePlan(d=d, hw=hw, slabs=slabs, parts=parts, cols=cols,
                      blocks=min(slabs * parts, sms), n_smem=n_smem, n_l2=N_GATES - n_smem,
                      gate_bytes=gate_bytes)


def device_plan(device: torch.device, d: int, h: int, w: int, gate_bytes: int = 4) -> VolumePlan:
    """plan_volume on `device`'s SM count and shared memory (cached)."""
    from cspn_tpu_torch.ops import _build

    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _limits:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            err = _build.load("cspn3d_fwd").cspn3d_device_limits(ctypes.byref(sms),
                                                                 ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"cspn3d_device_limits failed: cudaError_t {err}")
        _limits[index] = (sms.value, smem.value)
    return plan_volume(d, h, w, *_limits[index], gate_bytes=gate_bytes)


def _check_inputs(gates, x0):
    if gates.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {gates.device}")
    if gates.ndim != 5 or gates.shape[1] != N_GATES:
        raise ValueError(f"gates must be [M,26,D,H,W], got {tuple(gates.shape)}")
    m, _, d, h, w = gates.shape
    if m > 65535:
        raise ValueError(f"{m} volumes exceed the gate-cotangent pass's grid limit 65535")
    for name, t in (("gates", gates), ("x0", x0)):
        if t.device != gates.device:
            raise ValueError(f"{name} on {t.device}, gates on {gates.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(x0.shape) != (m, d, h, w):
        raise ValueError(f"x0 must be [{m},{d},{h},{w}], got {tuple(x0.shape)}")


def _gate_dtype(gate_dtype) -> torch.dtype:
    if gate_dtype not in GATE_DTYPES:
        raise ValueError(f"gate_dtype must be one of {GATE_DTYPES}, got {gate_dtype}")
    return gate_dtype


def _suffix(gates) -> str:
    """The C functions' suffix for the gates' storage dtype."""
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[gates.dtype]


def _launch(gates, x0, steps: int, keep_states: bool = False):
    """Run the forward kernel on checked inputs, the gates in their storage
    dtype (float32 or bf16).  Returns (out [M,D,H,W], states
    [steps-1,M,D,H,W] = x_1..x_{T-1} if keep_states else None).  A forward
    that keeps no states writes them into two buffers in turn."""
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("cspn3d_fwd")
    m, _, d, h, w = gates.shape
    fn = f"cspn3d_fwd_{_suffix(gates)}"
    plan = device_plan(gates.device, d, h, w, gates.element_size())
    out = torch.empty_like(x0)
    nslots = max(int(steps) - 1, 0)  # x_1 .. x_{T-1}
    if not keep_states:
        nslots = min(nslots, 2)
    states = x0.new_empty((nslots, m, d, h, w))
    with torch.cuda.device(gates.device):  # the runtime launches on the current device
        err = getattr(lib, fn)(
            gates.data_ptr(), x0.data_ptr(), out.data_ptr(), states.data_ptr(),
            m, d, h, w, int(steps), nslots, plan.blocks, plan.parts, plan.cols, plan.n_smem,
            torch.cuda.current_stream(gates.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err} ({plan})")
    launches += 1
    return out, (states if keep_states else None)


def _launch_bwd(gates, x0, states, ct, steps: int):
    """Run the backward kernel on checked inputs, the forward's kept
    `states` (x_1..x_{T-1}) and the cotangent `ct` of the output; returns
    (d gates [M,26,D,H,W], d x0 [M,D,H,W])."""
    global bwd_launches
    from cspn_tpu_torch.ops import _build

    if ct.dtype != torch.float32 or ct.device != x0.device or ct.shape != x0.shape:
        raise ValueError(f"the cotangent must be float32 {tuple(x0.shape)} on {x0.device}, "
                         f"got {ct.dtype} {tuple(ct.shape)} on {ct.device}")
    m, _, d, h, w = gates.shape
    if tuple(states.shape) != (max(int(steps) - 1, 0), m, d, h, w):
        raise ValueError(f"states must be the forward's [{max(int(steps) - 1, 0)},{m},{d},{h},{w}], "
                         f"got {tuple(states.shape)}")
    lib = _build.load("cspn3d_bwd")
    fn = f"cspn3d_bwd_{_suffix(gates)}"
    plan = device_plan(gates.device, d, h, w, gates.element_size())
    wbar = torch.empty(gates.shape, dtype=torch.float32, device=gates.device)  # f32 at any gate dtype
    x0bar = torch.empty_like(x0)
    vs = torch.empty_like(states)  # v_1 .. v_{T-1}
    with torch.cuda.device(gates.device):
        err = getattr(lib, fn)(
            gates.data_ptr(), x0.data_ptr(), states.data_ptr(), ct.data_ptr(), wbar.data_ptr(),
            x0bar.data_ptr(), vs.data_ptr(), m, d, h, w, int(steps), plan.blocks, plan.parts,
            plan.cols, plan.n_smem, torch.cuda.current_stream(gates.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError_t {err} ({plan})")
    bwd_launches += 1
    return wbar, x0bar


class _Propagate3d(torch.autograd.Function):
    """The forward that a backward will follow: the forward kernel on the
    gates in `gate_dtype`, keeping its states x_1..x_{T-1}; the backward
    kernel is the exact adjoint at those fixed gates, on those states, and
    its gate cotangents pass to the float32 gates unchanged."""

    @staticmethod
    def forward(ctx, gates, x0, steps, gate_dtype):
        g = gates.to(gate_dtype)
        out, states = _launch(g, x0, steps, keep_states=True)
        ctx.save_for_backward(g, x0, states)
        ctx.steps = steps
        return out

    @staticmethod
    def backward(ctx, grad_out):
        gates, x0, states = ctx.saved_tensors
        wbar, x0bar = _launch_bwd(gates, x0, states, grad_out.contiguous(), ctx.steps)
        return wbar, x0bar, None, None


def _run(gates, x0, steps: int, gate_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernels on checked inputs: a forward that a backward will follow
    keeps its states for it; any other forward keeps none."""
    if torch.is_grad_enabled() and (gates.requires_grad or x0.requires_grad):
        return _Propagate3d.apply(gates, x0, steps, gate_dtype)
    return _launch(gates.to(gate_dtype), x0, steps)[0]


def round_gates(gates: torch.Tensor, gate_dtype: torch.dtype) -> torch.Tensor:
    """The gates as the kernels read them at `gate_dtype`: rounded through
    bf16 (to nearest even) and widened back, the gradient passing through
    unchanged (autograd of the casts would round it too: ROADMAP.md Queue
    3, trap 8); float32 gates as they are."""
    if _gate_dtype(gate_dtype) == torch.float32:
        return gates
    return gates + (gates.to(gate_dtype).to(gates.dtype) - gates).detach()


def propagate3d_reference(gates: torch.Tensor, x0: torch.Tensor, *, steps: int = 24,
                          gate_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernels' plain version on any device: the plain sweep
    (cspn_ref.propagate_nd_reference) on the gates as the kernels read them
    at `gate_dtype` (`round_gates`), autograd-native."""
    return cspn_ref.propagate_nd_reference(round_gates(gates, gate_dtype), x0, steps)


def propagate3d(gates: torch.Tensor, x0: torch.Tensor, *, steps: int = 24,
                gate_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`steps` 3D propagation steps on fixed normalized gates read in
    `gate_dtype` (the function of affinity_propagate3d_fused at that
    gate_dtype; the state is float32).  A CPU tensor goes to the plain
    version, a CUDA tensor to the kernels.

    Args:
        gates: [M, 26, D, H, W] per-voxel gates in neighbor_offsets(3, 3)
            order.
        x0: [M, D, H, W].
    Returns [M, D, H, W], differentiable in gates and x0.
    """
    if gates.device.type == "cpu":
        return propagate3d_reference(gates, x0, steps=steps, gate_dtype=gate_dtype)
    _check_inputs(gates, x0)
    return _run(gates, x0, steps, _gate_dtype(gate_dtype))


def _cspn3d(guide, feat, steps: int, channel_first: bool, propagate) -> torch.Tensor:
    """The module around `propagate(gates, x0, steps=)`: abs and
    per-channel-group sum-normalization of the guide, the C channels folded
    into the volumes."""
    g = guide if channel_first else guide.movedim(-1, 1)
    f = feat if channel_first else feat.movedim(-1, 1)
    if f.ndim != 5 or g.ndim != 5:
        raise ValueError(f"3D CSPN takes 5-d guide and feat, got {tuple(guide.shape)}, "
                         f"{tuple(feat.shape)}")
    n, c = f.shape[:2]
    if g.shape[1] != c * N_GATES:
        raise ValueError(f"guide channels {g.shape[1]} != C*26 = {c * N_GATES}")
    gates = cspn_ref.normalize_gates_nd(g.movedim(1, -1), N_GATES)  # [N,D,H,W,C,26]
    gates = gates.permute(0, 4, 5, 1, 2, 3).flatten(0, 1).contiguous()  # [N*C,26,D,H,W]
    out = propagate(gates, f.flatten(0, 1).contiguous(), steps=steps).unflatten(0, (n, c))
    return out if channel_first else out.movedim(1, -1)


def cspn3d_cuda(
    guide: torch.Tensor,
    feat: torch.Tensor,
    *,
    steps: int = 24,
    channel_first: bool = False,
    gate_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Multi-step 3D CSPN module (paddle demo semantics, demo.py:20-54) on
    the kernels: abs and per-channel-group sum-normalization of the guide in
    PyTorch, the C channels folded into the volumes, `steps` kernel steps
    on the gates read in `gate_dtype`.

    Args:
        guide: [N, D, H, W, C*26] (or [N, C*26, D, H, W] with
            channel_first=True) raw guidance.
        feat: [N, D, H, W, C] (or [N, C, D, H, W]).
    Returns feat's shape and layout, float32.
    """
    return _cspn3d(guide, feat, steps, channel_first,
                   functools.partial(propagate3d, gate_dtype=gate_dtype))


def cspn3d_reference(guide: torch.Tensor, feat: torch.Tensor, *, steps: int = 24,
                     channel_first: bool = False,
                     gate_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`cspn3d_cuda`'s plain version on any device (`propagate3d_reference`)."""
    return _cspn3d(guide, feat, steps, channel_first,
                   functools.partial(propagate3d_reference, gate_dtype=gate_dtype))
