"""Hopper kernel for the paddle-semantics 2D CSPN (counterpart of
cspn_tpu/ops/cspn_pallas.py:_cspn2d_paddle_vjp and its _paddle2d_kernel,
cspn_nd's 2D branch).

The kernel is hand-written CUDA C++ in csrc/paddle2d.cu (the paddle
instantiation of the K-step tile stencil of csrc/cspn2d_tile.cuh; its
header says what bounds it), built by ops/_build.py and called through
ctypes on PyTorch's current stream.  It runs `steps` propagation steps on
fixed normalized gates; `paddle2d_layout` puts the guide and features into
its layout in PyTorch (abs, per-channel sum-normalization with the
max(., 1e-12) guard, the C channels folded into the maps, raster gate
order), as JAX does in XLA around its kernel (cspn_pallas.py:709-718).

`propagate2d` is the kernel's wrapper.  A tensor on the CPU goes to the
plain version (ops/cspn_ref.py:propagate_nd_reference) because it lies on
the CPU; a CUDA tensor goes to the kernel or raises.  The backward is
autograd of that plain version on the same device, as JAX rematerializes
its gradient through its XLA reference (cspn_pallas.py:757-766): the only
backward this function has on any device, not a fallback.

`launches` counts the kernel's runs (one per forward: ceil(steps / 8)
tile launches on the card).
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn_halo_cuda import HALO, TILE  # csrc/cspn2d_tile.cuh's

N_GATES = 8

launches = 0


def paddle2d_layout(guide: torch.Tensor, feat: torch.Tensor, channel_first: bool = False):
    """The kernel's inputs from cspn_nd's 2D arguments.

    Args:
        guide: [N, H, W, C*8] raw guidance (or [N, C*8, H, W] with
            channel_first=True), each channel's 8 gates in paddle raster
            order (neighbor_offsets(2, 3)).
        feat: [N, H, W, C] (or [N, C, H, W]).
    Returns (gates [N*C, 8, H, W] normalized, raster order; x0 [N*C, H, W]),
    both contiguous, differentiable in guide and feat.
    """
    g = guide if channel_first else guide.movedim(-1, 1)
    f = feat if channel_first else feat.movedim(-1, 1)
    if f.ndim != 4 or g.ndim != 4:
        raise ValueError(f"2D CSPN takes 4-d guide and feat, got {tuple(guide.shape)}, "
                         f"{tuple(feat.shape)}")
    c = f.shape[1]
    if g.shape[1] != c * N_GATES:
        raise ValueError(f"guide channels {g.shape[1]} != C*8 = {c * N_GATES}")
    gates = cspn_ref.normalize_gates_nd(g.movedim(1, -1), N_GATES)  # [N,H,W,C,8]
    gates = gates.permute(0, 3, 4, 1, 2).flatten(0, 1).contiguous()  # [N*C,8,H,W]
    return gates, f.flatten(0, 1).contiguous()


def _check_inputs(gates, x0):
    if gates.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {gates.device}")
    if gates.ndim != 4 or gates.shape[1] != N_GATES:
        raise ValueError(f"gates must be [M,8,H,W], got {tuple(gates.shape)}")
    m, _, h, w = gates.shape
    if m > 65535:
        raise ValueError(f"{m} maps exceed the kernel's grid limit 65535")
    for name, t in (("gates", gates), ("x0", x0)):
        if t.device != gates.device:
            raise ValueError(f"{name} on {t.device}, gates on {gates.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(x0.shape) != (m, h, w):
        raise ValueError(f"x0 must be [{m},{h},{w}], got {tuple(x0.shape)}")


def _launch(gates, x0, steps: int) -> torch.Tensor:
    """Run the kernel on checked inputs; returns [M, H, W] f32."""
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("paddle2d")
    m, _, h, w = gates.shape
    out = torch.empty_like(x0)
    x_scratch = torch.empty_like(x0)
    with torch.cuda.device(gates.device):  # the runtime launches on the current device
        err = lib.paddle2d_f32(
            gates.data_ptr(), x0.data_ptr(), out.data_ptr(), x_scratch.data_ptr(),
            m, h, w, int(steps), TILE, HALO, torch.cuda.current_stream(gates.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paddle2d_f32 launch failed: cudaError_t {err}")
    launches += 1
    return out


class _Propagate2d(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: autograd of the plain version at
    the saved inputs, on their device (JAX's remat backward)."""

    @staticmethod
    def forward(ctx, gates, x0, steps):
        ctx.save_for_backward(gates, x0)
        ctx.steps = steps
        return _launch(gates, x0, steps)

    @staticmethod
    def backward(ctx, grad_out):
        gates, x0 = ctx.saved_tensors
        with torch.enable_grad():
            g, x = gates.detach().requires_grad_(True), x0.detach().requires_grad_(True)
            y = cspn_ref.propagate_nd_reference(g, x, ctx.steps)
            dg, dx = torch.autograd.grad(y, (g, x), grad_out, allow_unused=True)
        return torch.zeros_like(gates) if dg is None else dg, dx, None  # steps=0: y is x


def propagate2d(gates: torch.Tensor, x0: torch.Tensor, *, steps: int = 24) -> torch.Tensor:
    """`steps` paddle 2D propagation steps on fixed normalized gates.

    Args:
        gates: [M, 8, H, W] per-pixel gates in neighbor_offsets(2, 3) order.
        x0: [M, H, W].
    Returns [M, H, W], differentiable in gates and x0.
    """
    if gates.device.type == "cpu":
        return cspn_ref.propagate_nd_reference(gates, x0, steps)
    _check_inputs(gates, x0)
    return _Propagate2d.apply(gates, x0, steps)


def cspn2d_paddle_cuda(
    guide: torch.Tensor,
    feat: torch.Tensor,
    *,
    steps: int = 24,
    channel_first: bool = False,
) -> torch.Tensor:
    """Multi-step 2D CSPN module (paddle demo semantics, demo.py:20-54):
    `paddle2d_layout`, then `steps` kernel steps.  Takes and returns
    cspn_nd's 2D layout (feat [N, H, W, C], or [N, C, H, W] with
    channel_first=True), float32."""
    gates, x0 = paddle2d_layout(guide, feat, channel_first)
    n, c = feat.shape[0], (feat.shape[1] if channel_first else feat.shape[-1])
    out = propagate2d(gates, x0, steps=steps).unflatten(0, (n, c))
    return out if channel_first else out.movedim(1, -1)
