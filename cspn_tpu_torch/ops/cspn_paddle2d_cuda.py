"""Hopper kernel for the paddle-semantics 2D CSPN (counterpart of
cspn_tpu/ops/cspn_pallas.py:_cspn2d_paddle_vjp and its _paddle2d_kernel,
cspn_nd's 2D branch).

The kernel is hand-written CUDA C++ in csrc/paddle2d.cu (the 2D CSPN's
column march of csrc/cspn2d_march.cuh with a centre tap; its header says
what bounds it), built by ops/_build.py and called through ctypes on
PyTorch's current stream.  It reads the raw guide and the features in
cspn_nd's own 2D layouts and writes the output in the same layout: the
gates' abs, per-channel sum-normalization with the max(., 1e-12) guard,
the centre weight and the gate order's reversal happen in registers as it
loads, where JAX runs them in XLA around its kernel
(cspn_pallas.py:709-718).  So on the card cspn_nd's 2D forward is the
kernel's launches and nothing else.

`cspn2d_paddle_cuda` is the kernel's wrapper.  A tensor on the CPU goes to
the plain version (`paddle2d_reference`, ops/cspn_ref.py:cspn_nd_reference)
because it lies on the CPU; a CUDA tensor goes to the kernel or raises.
The backward is autograd of that plain version at the saved raw guide and
features, on their device, as JAX rematerializes its gradient through its
XLA reference (cspn_pallas.py:757-766): the only backward this function
has on any device, not a fallback.

`launches` counts the kernel's runs (one per forward: `cuda_launches(steps)`
march launches on the card).
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops import cspn_ref

N_GATES = 8
STEPS_PER_LAUNCH = 12  # csrc/cspn2d_march.cuh: kHalo

launches = 0


def cuda_launches(steps: int) -> int:
    """The CUDA launches of one forward: ceil(steps / 12), none at 0 steps
    (a device-to-device copy)."""
    return -(-steps // STEPS_PER_LAUNCH) if steps > 0 else 0


def _check_args(guide: torch.Tensor, feat: torch.Tensor, channel_first: bool) -> tuple:
    """(N, C, H, W) of cspn_nd's 2D arguments; raises on others."""
    if feat.ndim != 4 or guide.ndim != 4:
        raise ValueError(f"2D CSPN takes 4-d guide and feat, got {tuple(guide.shape)}, "
                         f"{tuple(feat.shape)}")
    if channel_first:
        n, c, h, w = feat.shape
        want = (n, c * N_GATES, h, w)
    else:
        n, h, w, c = feat.shape
        want = (n, h, w, c * N_GATES)
    if tuple(guide.shape) != want:
        raise ValueError(f"guide {tuple(guide.shape)} must be {want}: C*8 = {c * N_GATES} "
                         "gate channels on feat's map")
    return n, c, h, w


def paddle2d_reference(guide: torch.Tensor, feat: torch.Tensor, *, steps: int = 24,
                       channel_first: bool = False) -> torch.Tensor:
    """The kernel's plain version: cspn_nd_reference in the caller's layout."""
    _check_args(guide, feat, channel_first)
    if channel_first:
        guide, feat = guide.movedim(1, -1), feat.movedim(1, -1)
    out = cspn_ref.cspn_nd_reference(guide, feat, kernel_size=3, steps=steps)
    return out.movedim(-1, 1) if channel_first else out


def _check_inputs(guide, feat, channel_first: bool) -> tuple:
    if guide.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {guide.device}")
    n, c, h, w = _check_args(guide, feat, channel_first)
    if n * c > 65535:
        raise ValueError(f"{n * c} maps exceed the kernel's grid limit 65535")
    for name, t in (("guide", guide), ("feat", feat)):
        if t.device != guide.device:
            raise ValueError(f"{name} on {t.device}, guide on {guide.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, c, h, w


def _launch(guide, feat, steps: int, channel_first: bool = False) -> torch.Tensor:
    """Run the kernel on checked inputs; returns feat's shape and layout, f32."""
    global launches
    from cspn_tpu_torch.ops import _build

    n, c, h, w = _check_inputs(guide, feat, channel_first)
    lib = _build.load("paddle2d")
    out = torch.empty_like(feat)
    x_scratch = torch.empty_like(feat)
    with torch.cuda.device(guide.device):  # the runtime launches on the current device
        err = lib.paddle2d_f32(
            guide.data_ptr(), feat.data_ptr(), out.data_ptr(), x_scratch.data_ptr(),
            n, c, h, w, int(steps), int(not channel_first),
            torch.cuda.current_stream(guide.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paddle2d_f32 launch failed: cudaError_t {err}")
    launches += 1
    return out


class _Paddle2d(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: autograd of the plain version at
    the saved raw guide and features, on their device (JAX's remat
    backward)."""

    @staticmethod
    def forward(ctx, guide, feat, steps, channel_first):
        ctx.save_for_backward(guide, feat)
        ctx.steps, ctx.channel_first = steps, channel_first
        return _launch(guide, feat, steps, channel_first)

    @staticmethod
    def backward(ctx, grad_out):
        guide, feat = ctx.saved_tensors
        with torch.enable_grad():
            g, f = guide.detach().requires_grad_(True), feat.detach().requires_grad_(True)
            y = paddle2d_reference(g, f, steps=ctx.steps, channel_first=ctx.channel_first)
            dg, df = torch.autograd.grad(y, (g, f), grad_out, allow_unused=True)
        return torch.zeros_like(guide) if dg is None else dg, df, None, None  # steps=0: y is f


def cspn2d_paddle_cuda(
    guide: torch.Tensor,
    feat: torch.Tensor,
    *,
    steps: int = 24,
    channel_first: bool = False,
) -> torch.Tensor:
    """Multi-step 2D CSPN module (paddle demo semantics, demo.py:20-54) in
    cspn_nd's 2D layout: guide [N, H, W, C*8] raw, each channel's 8 gates in
    paddle raster order (neighbor_offsets(2, 3)), and feat [N, H, W, C]; or
    [N, C*8, H, W] and [N, C, H, W] with channel_first=True.  Returns feat's
    shape, float32, differentiable in guide and feat."""
    if guide.device.type == "cpu":
        return paddle2d_reference(guide, feat, steps=steps, channel_first=channel_first)
    return _Paddle2d.apply(guide, feat, steps, channel_first)
