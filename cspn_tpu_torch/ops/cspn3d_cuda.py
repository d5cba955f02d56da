"""Hopper kernels for the 3D CSPN forward and backward (counterpart of
cspn_tpu/ops/cspn3d_pallas.py: affinity_propagate3d_fused and its
_seg_kernel, affinity_propagate3d_fused_bwd and its _bwd3_kernel, wired
together by cspn_pallas.py:_cspn3d_fused_vjp).

The kernels are hand-written CUDA C++ in csrc/cspn3d_fwd.cu and
csrc/cspn3d_bwd.cu (their headers say what bounds them and what the design
leaves open), built by ops/_build.py and called through ctypes on PyTorch's
current stream.  They run `steps` propagation steps on fixed normalized
gates; the abs and per-group sum-normalization around them stay plain
PyTorch (autograd gives their quotient-rule backward), as JAX leaves them
to XLA (cspn3d_pallas.py:558-564, cspn_pallas.py:1520-1536).

`propagate3d` is the kernels' wrapper.  A tensor on the CPU goes to their
plain version (ops/cspn_ref.py:propagate_nd_reference, autograd-native)
because it lies on the CPU; a CUDA tensor goes to the kernels or raises,
forward and backward.  There is no fallback between the two.

`launches` counts the forward kernel's runs (one per forward: `steps` step
launches on the card); `bwd_launches` counts the backward kernel's runs
(one per backward: `steps - 1` replay steps, a centre launch, `steps`
reverse steps and one gate-cotangent launch).
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops import cspn_ref

N_GATES = 26

launches = 0
bwd_launches = 0


def _check_inputs(gates, x0):
    if gates.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {gates.device}")
    if gates.ndim != 5 or gates.shape[1] != N_GATES:
        raise ValueError(f"gates must be [M,26,D,H,W], got {tuple(gates.shape)}")
    m, _, d, h, w = gates.shape
    if m > 65535:
        raise ValueError(f"{m} volumes exceed the kernel's grid limit 65535")
    for name, t in (("gates", gates), ("x0", x0)):
        if t.device != gates.device:
            raise ValueError(f"{name} on {t.device}, gates on {gates.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(x0.shape) != (m, d, h, w):
        raise ValueError(f"x0 must be [{m},{d},{h},{w}], got {tuple(x0.shape)}")


def _launch(gates, x0, steps: int) -> torch.Tensor:
    """Run the forward kernel on checked inputs; returns [M, D, H, W] f32."""
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("cspn3d_fwd")
    m, _, d, h, w = gates.shape
    out = torch.empty_like(x0)
    x_scratch = torch.empty_like(x0)
    with torch.cuda.device(gates.device):  # the runtime launches on the current device
        err = lib.cspn3d_fwd_f32(
            gates.data_ptr(), x0.data_ptr(), out.data_ptr(), x_scratch.data_ptr(),
            m, d, h, w, int(steps), torch.cuda.current_stream(gates.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn3d_fwd_f32 launch failed: cudaError_t {err}")
    launches += 1
    return out


def _launch_bwd(gates, x0, ct, steps: int):
    """Run the backward kernel on checked inputs and the cotangent `ct` of
    the output; returns (d gates [M,26,D,H,W], d x0 [M,D,H,W])."""
    global bwd_launches
    from cspn_tpu_torch.ops import _build

    if ct.dtype != torch.float32 or ct.device != x0.device or ct.shape != x0.shape:
        raise ValueError(f"the cotangent must be float32 {tuple(x0.shape)} on {x0.device}, "
                         f"got {ct.dtype} {tuple(ct.shape)} on {ct.device}")
    lib = _build.load("cspn3d_bwd")
    m, _, d, h, w = gates.shape
    wbar = torch.empty_like(gates)
    x0bar = torch.empty_like(x0)
    center = torch.empty_like(x0)
    # x_1 .. x_{T-1} and v_1 .. v_{T-1}
    states = x0.new_empty((max(int(steps) - 1, 0), m, d, h, w))
    vs = torch.empty_like(states)
    with torch.cuda.device(gates.device):
        err = lib.cspn3d_bwd_f32(
            gates.data_ptr(), x0.data_ptr(), ct.data_ptr(), wbar.data_ptr(), x0bar.data_ptr(),
            center.data_ptr(), states.data_ptr(), vs.data_ptr(),
            m, d, h, w, int(steps), torch.cuda.current_stream(gates.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cspn3d_bwd_f32 launch failed: cudaError_t {err}")
    bwd_launches += 1
    return wbar, x0bar


class _Propagate3d(torch.autograd.Function):
    """Forward and backward are the CUDA kernels: the exact adjoint at the
    fixed gates the forward saved."""

    @staticmethod
    def forward(ctx, gates, x0, steps):
        ctx.save_for_backward(gates, x0)
        ctx.steps = steps
        return _launch(gates, x0, steps)

    @staticmethod
    def backward(ctx, grad_out):
        gates, x0 = ctx.saved_tensors
        wbar, x0bar = _launch_bwd(gates, x0, grad_out.contiguous(), ctx.steps)
        return wbar, x0bar, None


def propagate3d(gates: torch.Tensor, x0: torch.Tensor, *, steps: int = 24) -> torch.Tensor:
    """`steps` 3D propagation steps on fixed normalized gates (the function
    of affinity_propagate3d_fused at gate_dtype=float32).

    Args:
        gates: [M, 26, D, H, W] per-voxel gates in neighbor_offsets(3, 3)
            order.
        x0: [M, D, H, W].
    Returns [M, D, H, W], differentiable in gates and x0.
    """
    if gates.device.type == "cpu":
        return cspn_ref.propagate_nd_reference(gates, x0, steps)
    _check_inputs(gates, x0)
    return _Propagate3d.apply(gates, x0, steps)


def cspn3d_cuda(
    guide: torch.Tensor,
    feat: torch.Tensor,
    *,
    steps: int = 24,
    channel_first: bool = False,
) -> torch.Tensor:
    """Multi-step 3D CSPN module (paddle demo semantics, demo.py:20-54) on
    the kernels: abs and per-channel-group sum-normalization of the guide in
    PyTorch, the C channels folded into the volumes, `steps` kernel steps.

    Args:
        guide: [N, D, H, W, C*26] (or [N, C*26, D, H, W] with
            channel_first=True) raw guidance.
        feat: [N, D, H, W, C] (or [N, C, D, H, W]).
    Returns feat's shape and layout, float32.
    """
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
    out = propagate3d(gates, f.flatten(0, 1).contiguous(), steps=steps).unflatten(0, (n, c))
    return out if channel_first else out.movedim(1, -1)
