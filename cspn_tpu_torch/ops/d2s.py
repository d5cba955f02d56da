"""2x depth-to-space for the subpixel decoder, and its adjoint (counterpart
of cspn_tpu/ops/d2s_pallas.py).

The subpixel decoder (models/decoder.py:SubpixelUnpoolConv) computes each
`zero-insert unpool -> k x k conv` pair as half-resolution convs into four
phase groups, then interleaves the phases.  NCHW:

    [N, 4C, H, W] -> [N, C, oheight, owidth],
    out[n, c, 2y+py, 2x+px] = in[n, (px*2+py)*C + c, y, x],

cropped to (oheight, owidth) -- the JAX package's px-major phase order, which
the weight reindex (decoder.py:_subpixel_weights) produces.  The input is
that one tensor, or the four phases as a sequence of [N, C, H, W] tensors,
px-major (phase px*2+py): the outputs of the four phase convs the decoder
runs from 128 features (decoder.py:_subpixel_convs), which nothing then
concatenates (the JAX package's XLA fuses its concatenation into the
relayout; in PyTorch it would be a pass of its own).

Backends, as in ops/cspn.py:
    'kernel'    -- the hand-written CUDA kernels in csrc/d2s.cu (`d2s`
                   forward, `s2d` backward: the exact adjoint, zeros where
                   the crop cut, one gradient per phase tensor given);
                   CUDA tensors only.
    'reference' -- the plain PyTorch version `depth_to_space2_ref`
                   (concatenate the phases, view, permute, copy, slice),
                   any device, autograd-native.
    'auto'      -- the kernel for CUDA tensors, the reference otherwise.

On a CUDA tensor 'auto' runs the kernels or raises, forward and backward,
for every element size of 2, 4 or 8 bytes: there is no fallback.

Deliberate difference from JAX: the JAX package defaults to its reshape /
transpose form (`backend='jnp'`) because its MXU-permutation Pallas kernel
lost to XLA's relayout on TPU v5e (d2s_pallas.py:26-47).  That reason is
the TPU's; on the card a kernel moves each byte once, so 'auto' takes the
kernel.

Both kernels are torch custom ops, `cspn_tpu_torch::d2s` and
`cspn_tpu_torch::s2d`: the CUDA implementation launches the kernel, the
CPU one is the plain version, the fake one gives the shapes, and `d2s`'s
registered autograd calls `s2d`.  The training and serving paths run the
same op, and `torch.export` records it as one node (export.py).

`launches` counts the forward kernel's runs, `bwd_launches` the backward's
(one launch each per call, in either form), counted where the kernel is
launched, so an exported program's runs count too.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

BACKENDS = ("auto", "kernel", "reference")
_ELEMENT_SIZES = (2, 4, 8)

launches = 0
bwd_launches = 0

Phases = torch.Tensor | Sequence[torch.Tensor]


def _joined(x: Phases) -> torch.Tensor:
    """The [N, 4C, H, W] tensor of `x`: itself, or its four phases
    concatenated."""
    return x if isinstance(x, torch.Tensor) else torch.cat(list(x), 1)


def depth_to_space2_ref(x: Phases, oheight: int, owidth: int) -> torch.Tensor:
    """Plain form: [N, 4C, H, W] (or its four phases) -> [N, 2H, 2W]
    interleave -> crop (counterpart of d2s_pallas.py:depth_to_space2_jnp)."""
    x = _joined(x)
    n, c4, h, w = x.shape
    c = c4 // 4
    v = x.reshape(n, 2, 2, c, h, w)  # [n, px, py, c, y, x]
    y = v.permute(0, 3, 4, 2, 5, 1).reshape(n, c, 2 * h, 2 * w)  # [n, c, (y, py), (x, px)]
    return y[:, :, :oheight, :owidth]


def space_to_depth2_ref(ct: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Plain adjoint of `depth_to_space2_ref`: [N, C, oh, ow] -> [N, 4C,
    height, width], zeros where the crop cut (phase k: channels k*C to
    (k+1)*C)."""
    n, c, oh, ow = ct.shape
    full = ct.new_zeros((n, c, 2 * height, 2 * width))
    full[:, :, :oh, :ow] = ct
    v = full.view(n, c, height, 2, width, 2)  # [n, c, y, py, x, px]
    return v.permute(0, 5, 3, 1, 2, 4).reshape(n, 4 * c, height, width)


def _check_cuda(dtype: torch.dtype, numel: int) -> None:
    """Raise on what the kernels do not take: `numel` is the larger side's."""
    if dtype.itemsize not in _ELEMENT_SIZES:
        raise TypeError(f"the kernels move elements of {_ELEMENT_SIZES} bytes, got {dtype}")
    if numel >= 2**31:
        raise ValueError(f"{numel} elements exceed the kernels' 32-bit indexing")


def _phase_pointers(x: Phases) -> tuple[list[int], int]:
    """The four phases' base pointers and their sample stride in elements,
    of one contiguous [N, 4C, H, W] tensor or of four contiguous phases."""
    if isinstance(x, torch.Tensor):
        n, c4, h, w = x.shape
        step = (c4 // 4) * h * w * x.element_size()
        return [x.data_ptr() + k * step for k in range(4)], c4 * h * w
    _, c, h, w = x[0].shape
    return [t.data_ptr() for t in x], c * h * w


def _launch(x: Phases, oheight: int, owidth: int) -> torch.Tensor:
    """The `d2s` kernel on one contiguous CUDA tensor [N, 4C, H, W] or its
    four contiguous phases [N, C, H, W]; returns [N, C, oh, ow]."""
    global launches
    from cspn_tpu_torch.ops import _build

    first = x if isinstance(x, torch.Tensor) else x[0]
    n, c, h, w = first.shape
    if isinstance(x, torch.Tensor):
        c //= 4
    _check_cuda(first.dtype, n * 4 * c * h * w)
    lib = _build.load("d2s")
    out = first.new_empty((n, c, oheight, owidth))
    ptrs, stride = _phase_pointers(x)
    with torch.cuda.device(first.device):
        err = lib.d2s(*ptrs, out.data_ptr(), n, c, h, w, oheight, owidth, stride,
                      first.element_size(), torch.cuda.current_stream(first.device).cuda_stream)
    if err != 0:  # 1, cudaErrorInvalidValue: a row too wide for a block's shared memory
        raise RuntimeError(f"d2s launch failed: cudaError_t {err}")
    launches += 1
    return out


def _launch_bwd(ct: torch.Tensor, height: int, width: int, phases: bool = False):
    """The `s2d` kernel on a contiguous CUDA cotangent [N, C, oh, ow];
    returns [N, 4C, height, width], or with `phases` the four phase
    gradients [N, C, height, width], each contiguous."""
    global bwd_launches
    from cspn_tpu_torch.ops import _build

    n, c, oh, ow = ct.shape
    shape = (n, c, height, width)
    _check_cuda(ct.dtype, n * 4 * c * height * width)
    lib = _build.load("d2s")
    out = ([ct.new_empty(shape) for _ in range(4)] if phases
           else ct.new_empty((n, 4 * c, height, width)))
    ptrs, stride = _phase_pointers(out)
    with torch.cuda.device(ct.device):
        err = lib.s2d(ct.data_ptr(), *ptrs, n, c, height, width, oh, ow, stride,
                      ct.element_size(), torch.cuda.current_stream(ct.device).cuda_stream)
    if err != 0:  # as d2s
        raise RuntimeError(f"s2d launch failed: cudaError_t {err}")
    bwd_launches += 1
    return out


def _one_or_phases(xs: list[torch.Tensor]) -> Phases:
    return xs if len(xs) == 4 else xs[0]


# The CUDA implementations make their inputs contiguous themselves: in a
# traced graph a tensor's strides are those its fake tensor had at trace
# time, which need not be the real ones (cuDNN gives a channels-last
# convolution output where the fake convolution gave a contiguous one, so
# a `.contiguous()` before the op was traced as a no-op).
@torch.library.custom_op("cspn_tpu_torch::d2s", mutates_args=(), device_types="cuda")
def d2s_op(xs: list[torch.Tensor], oheight: int, owidth: int) -> torch.Tensor:
    """The `d2s` kernel as a torch op: `xs` is [one [N, 4C, H, W] tensor] or
    its four phases [N, C, H, W], px-major; returns [N, C, oheight, owidth]."""
    return _launch(_one_or_phases([t.contiguous() for t in xs]), oheight, owidth)


# the CPU implementations copy what the plain versions give: an op's
# output may not alias its inputs or its other outputs, which a view may
@d2s_op.register_kernel("cpu")
def _d2s_plain(xs, oheight, owidth):
    return depth_to_space2_ref(_one_or_phases(xs), oheight, owidth).clone(
        memory_format=torch.contiguous_format)


@d2s_op.register_fake
def _(xs, oheight, owidth):
    n, c, _, _ = xs[0].shape
    return xs[0].new_empty((n, c if len(xs) == 4 else c // 4, oheight, owidth))


@torch.library.custom_op("cspn_tpu_torch::s2d", mutates_args=(), device_types="cuda")
def s2d_op(ct: torch.Tensor, height: int, width: int, phases: bool) -> list[torch.Tensor]:
    """The `s2d` kernel as a torch op: the cotangent [N, C, oh, ow] -> [the
    gradient [N, 4C, height, width]], or with `phases` the four contiguous
    phase gradients [N, C, height, width]."""
    out = _launch_bwd(ct.contiguous(), height, width, phases=phases)
    return out if phases else [out]


@s2d_op.register_kernel("cpu")
def _s2d_plain(ct, height, width, phases):
    full = space_to_depth2_ref(ct, height, width)
    return [p.clone(memory_format=torch.contiguous_format)
            for p in (full.chunk(4, 1) if phases else [full])]


@s2d_op.register_fake
def _(ct, height, width, phases):
    n, c, _, _ = ct.shape
    if phases:
        return [ct.new_empty((n, c, height, width)) for _ in range(4)]
    return [ct.new_empty((n, 4 * c, height, width))]


def _d2s_setup(ctx, inputs, output):
    xs, _, _ = inputs
    ctx.hw, ctx.phases = tuple(xs[0].shape[2:]), len(xs) == 4


def _d2s_backward(ctx, ct):
    """The custom VJP of d2s_pallas.py:_d2s: one gradient per tensor given."""
    return torch.ops.cspn_tpu_torch.s2d(ct, *ctx.hw, ctx.phases), None, None


d2s_op.register_autograd(_d2s_backward, setup_context=_d2s_setup)


def _check_phases(x: Sequence[torch.Tensor]) -> tuple[int, int]:
    """(H, W) of four phases of one shape, dtype and device."""
    if len(x) != 4 or not all(isinstance(t, torch.Tensor) for t in x):
        raise ValueError(f"expected one [N, 4C, H, W] tensor or its four phases, got {len(x)} items")
    if x[0].ndim != 4:
        raise ValueError(f"phases must be [N, C, H, W], got {tuple(x[0].shape)}")
    if any(t.shape != x[0].shape or t.dtype != x[0].dtype or t.device != x[0].device
           for t in x[1:]):
        raise ValueError("the four phases must share shape, dtype and device, got "
                         + ", ".join(f"{tuple(t.shape)} {t.dtype} {t.device}" for t in x))
    return tuple(x[0].shape[2:])


def depth_to_space2(x: Phases, oheight: int, owidth: int, *,
                    backend: str = "auto") -> torch.Tensor:
    """[N, 4*C, H, W] (channel (px*2+py)*C + c), or its four phases
    [N, C, H, W] px-major, -> [N, C, oheight, owidth]; differentiable in x
    (in each phase)."""
    if isinstance(x, torch.Tensor):
        if x.ndim != 4:
            raise ValueError(f"input must be [N, 4C, H, W], got {tuple(x.shape)}")
        _, c4, h, w = x.shape
        if c4 % 4:
            raise ValueError(f"channel dim {c4} not a multiple of 4")
        xs, device = (x,), x.device
    else:
        h, w = _check_phases(x)
        xs, device = tuple(x), x[0].device
    if not (0 < oheight <= 2 * h and 0 < owidth <= 2 * w):
        raise ValueError(f"crop ({oheight},{owidth}) outside 2x of {(h, w)}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    on_cuda = device.type == "cuda"
    if backend == "kernel" and not on_cuda:
        raise ValueError(f"backend='kernel' needs CUDA tensors, got {device}; "
                         "use 'reference' (or 'auto') on the CPU")
    if backend == "reference" or not on_cuda:
        return depth_to_space2_ref(x, oheight, owidth)
    return torch.ops.cspn_tpu_torch.d2s(list(xs), oheight, owidth)
