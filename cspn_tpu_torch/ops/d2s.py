"""2x depth-to-space for the subpixel decoder, and its adjoint (counterpart
of cspn_tpu/ops/d2s_pallas.py).

The subpixel decoder (models/decoder.py:SubpixelUnpoolConv) computes each
`zero-insert unpool -> k x k conv` pair as one half-resolution conv into four
phase groups, then interleaves the phases.  NCHW:

    [N, 4C, H, W] -> [N, C, oheight, owidth],
    out[n, c, 2y+py, 2x+px] = in[n, (px*2+py)*C + c, y, x],

cropped to (oheight, owidth) -- the JAX package's px-major phase order, which
the weight reindex (decoder.py:_subpixel_weights) produces.

Backends, as in ops/cspn.py:
    'kernel'    -- the hand-written CUDA kernels in csrc/d2s.cu (`d2s`
                   forward, `s2d` backward: the exact adjoint, zeros where
                   the crop cut); CUDA tensors only.
    'reference' -- the plain PyTorch version `depth_to_space2_ref` (view,
                   permute, copy, slice), any device, autograd-native.
    'auto'      -- the kernel for CUDA tensors, the reference otherwise.

On a CUDA tensor 'auto' runs the kernels or raises, forward and backward,
for every element size of 2, 4 or 8 bytes: there is no fallback.

Deliberate difference from JAX: the JAX package defaults to its reshape /
transpose form (`backend='jnp'`) because its MXU-permutation Pallas kernel
lost to XLA's relayout on TPU v5e (d2s_pallas.py:26-47).  That reason is
the TPU's; on the card a gather kernel moves each byte once, so 'auto'
takes the kernel.

`launches` counts the forward kernel's runs, `bwd_launches` the backward's
(one launch each per call).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

BACKENDS = ("auto", "kernel", "reference")
_ELEMENT_SIZES = (2, 4, 8)

launches = 0
bwd_launches = 0


def depth_to_space2_ref(x: torch.Tensor, oheight: int, owidth: int) -> torch.Tensor:
    """Plain form: [N, 4C, H, W] -> [N, 2H, 2W] interleave -> crop
    (counterpart of d2s_pallas.py:depth_to_space2_jnp)."""
    n, c4, h, w = x.shape
    c = c4 // 4
    v = x.reshape(n, 2, 2, c, h, w)  # [n, px, py, c, y, x]
    y = v.permute(0, 3, 4, 2, 5, 1).reshape(n, c, 2 * h, 2 * w)  # [n, c, (y, py), (x, px)]
    return y[:, :, :oheight, :owidth]


def space_to_depth2_ref(ct: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Plain adjoint of `depth_to_space2_ref`: [N, C, oh, ow] -> [N, 4C,
    height, width], zeros where the crop cut."""
    n, c, oh, ow = ct.shape
    full = ct.new_zeros((n, c, 2 * height, 2 * width))
    full[:, :, :oh, :ow] = ct
    v = full.view(n, c, height, 2, width, 2)  # [n, c, y, py, x, px]
    return v.permute(0, 5, 3, 1, 2, 4).reshape(n, 4 * c, height, width)


def _check_cuda(t: torch.Tensor, numel: int) -> None:
    """Raise on what the kernels do not take: `numel` is the larger side's."""
    if t.element_size() not in _ELEMENT_SIZES:
        raise TypeError(f"the kernels move elements of {_ELEMENT_SIZES} bytes, got {t.dtype}")
    if numel >= 2**31:
        raise ValueError(f"{numel} elements exceed the kernels' 32-bit indexing")


def _launch(x: torch.Tensor, oheight: int, owidth: int) -> torch.Tensor:
    """The `d2s` kernel on a contiguous CUDA tensor; returns [N, C, oh, ow]."""
    global launches
    from cspn_tpu_torch.ops import _build

    _check_cuda(x, x.numel())
    lib = _build.load("d2s")
    n, c4, h, w = x.shape
    out = x.new_empty((n, c4 // 4, oheight, owidth))
    with torch.cuda.device(x.device):
        err = lib.d2s(x.data_ptr(), out.data_ptr(), n, c4 // 4, h, w, oheight, owidth,
                      x.element_size(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"d2s launch failed: cudaError_t {err}")
    launches += 1
    return out


def _launch_bwd(ct: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The `s2d` kernel on a contiguous CUDA cotangent [N, C, oh, ow];
    returns [N, 4C, height, width]."""
    global bwd_launches
    from cspn_tpu_torch.ops import _build

    n, c, oh, ow = ct.shape
    _check_cuda(ct, n * 4 * c * height * width)
    lib = _build.load("d2s")
    out = ct.new_empty((n, 4 * c, height, width))
    with torch.cuda.device(ct.device):
        err = lib.s2d(ct.data_ptr(), out.data_ptr(), n, c, height, width, oh, ow,
                      ct.element_size(), torch.cuda.current_stream(ct.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"s2d launch failed: cudaError_t {err}")
    bwd_launches += 1
    return out


class _DepthToSpace2(torch.autograd.Function):
    """Forward `d2s`, backward `s2d` (the custom VJP of d2s_pallas.py:_d2s)."""

    @staticmethod
    def forward(ctx, x, oheight, owidth):
        ctx.hw = x.shape[2:]
        return _launch(x.contiguous(), oheight, owidth)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        return _launch_bwd(ct.contiguous(), *ctx.hw), None, None


def depth_to_space2(x: torch.Tensor, oheight: int, owidth: int, *,
                    backend: str = "auto") -> torch.Tensor:
    """[N, 4*C, H, W] (channel (px*2+py)*C + c) -> [N, C, oheight, owidth];
    differentiable in x."""
    if x.ndim != 4:
        raise ValueError(f"input must be [N, 4C, H, W], got {tuple(x.shape)}")
    _, c4, h, w = x.shape
    if c4 % 4:
        raise ValueError(f"channel dim {c4} not a multiple of 4")
    if not (0 < oheight <= 2 * h and 0 < owidth <= 2 * w):
        raise ValueError(f"crop ({oheight},{owidth}) outside 2x of {(h, w)}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    on_cuda = x.device.type == "cuda"
    if backend == "kernel" and not on_cuda:
        raise ValueError(f"backend='kernel' needs CUDA tensors, got {x.device}; "
                         "use 'reference' (or 'auto') on the CPU")
    if backend == "reference" or not on_cuda:
        return depth_to_space2_ref(x, oheight, owidth)
    return _DepthToSpace2.apply(x, oheight, owidth)
