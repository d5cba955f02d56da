"""The int8 convolution's glue on the card (utils/quant.py:QuantConv):
three hand-written kernels in csrc/int8_conv.cu around `torch._int_mm`.

A QuantConv on a CUDA tensor runs, per conv:

    act_absmax(x)           -> scale [N]   (dynamic scales; a static scale
                                            skips it)
    int8_taps(x, scale, ..) -> A [M', K']  int8: quantize, pad and im2col
    torch._int_mm(A, W^T)   -> [M', O']    int32 (cuBLASLt)
    int8_dequant(acc, ..)   -> y [N, Ho, Wo, O] in x's dtype (bf16), or
                               with its epilogue relu?(bn(y) [+ residual])

where the PyTorch route (quantize_tensor, _taps, int8_matmul,
int8_conv_prequant's dequantization) runs ~14 passes a conv.  Every value
equals the PyTorch route's on the card bit for bit: the scales, the taps
and the output (csrc/int8_conv.cu gives the arithmetic).  M' = max(N * Ho
* Wo, 17) and K' = the weight matrix's padded K, so that `_int_mm` takes A
as it is; the dequantization drops the pad rows and columns.

The epilogue is the eval BN that follows the conv in the serving model,
its residual add and its ReLU (models/resnet.py:conv_bn): the BN's bf16
(mean, mul, bias) [O], mul = rsqrt(var + eps) * weight as the BN forms
it, and a bf16 residual [N, O, Ho, Wo], copied into channels-last memory
where it is not; each step is rounded to bf16 as the BN's, the add's and
torch.relu's own passes round it (csrc/int8_conv.cu), so the output is
theirs bit for bit.

The kernels take a bf16 activation in channels-last memory (the layout
the previous QuantConv's output keeps through the BN and ReLU;
QuantConv copies one in another layout into it once, for all its
products), scales in bf16 (dynamic, one a sample) or float32 (static,
one), and bf16 or float32 weight scales, on the input's card, and raise on
anything else: a CUDA tensor never reaches the PyTorch glue.

Each kernel is a torch custom op for the card alone, `cspn_tpu_torch::
act_absmax`, `::int8_taps` and `::int8_dequant`, with a fake
implementation that gives the shapes, the rows of A as `torch.sym_max(N *
Ho * Wo, 17)` where `torch.export` keeps the batch symbolic.  CPU tensors
never reach them: QuantConv takes the PyTorch route there.
`absmax_launches`, `taps_launches` and `dequant_launches` count the
kernels' runs where they launch (serving.py adds a graph replay's), and
`dequant_bn_launches` those of `dequant_launches` with the epilogue.
"""

from __future__ import annotations

import torch

MIN_ROWS = 17  # `_int_mm` on the card takes more than 16 rows

absmax_launches = 0
taps_launches = 0
dequant_launches = 0
dequant_bn_launches = 0

_SCALE_F32 = {torch.bfloat16: 0, torch.float32: 1}


def out_hw(h: int, w: int, kh: int, kw: int, stride: int, ph0: int, ph1: int, pw0: int,
           pw1: int) -> tuple[int, int]:
    return (h + ph0 + ph1 - kh) // stride + 1, (w + pw0 + pw1 - kw) // stride + 1


def _check_activation(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.bfloat16 or x.ndim != 4:
        raise TypeError(f"{what} takes a bf16 [N, C, H, W] activation, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what} takes channels-last memory, got strides {x.stride()}")


def _scale_code(scale: torch.Tensor, like: torch.Tensor, n: int, what: str) -> tuple[int, int]:
    """(float32?, one a sample?) of a scale: bf16 or float32, one for all or
    one a sample, on `like`'s card."""
    if scale.device != like.device:
        raise ValueError(f"{what}: the scale is on {scale.device}, the tensor on {like.device}")
    if scale.dtype not in _SCALE_F32:
        raise TypeError(f"{what}: scales are bf16 or float32, got {scale.dtype}")
    if scale.numel() not in (1, n):
        raise ValueError(f"{what}: {scale.numel()} scales for {n} samples")
    return _SCALE_F32[scale.dtype], int(scale.numel() > 1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_absmax(x: torch.Tensor) -> torch.Tensor:
    """The `act_absmax` kernel on a bf16 channels-last CUDA tensor; returns
    the per-sample scales [N] in bf16."""
    global absmax_launches
    from cspn_tpu_torch.ops import _build

    _check_activation(x, "act_absmax")
    n = x.shape[0]
    if x.numel() == 0 or n > 65535:
        raise ValueError(f"act_absmax takes 1 to 65535 non-empty samples, got {tuple(x.shape)}")
    lib = _build.load("int8_conv")
    work = torch.empty(n + 1, dtype=torch.int32, device=x.device)
    scale = torch.empty(n, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.act_absmax(x.data_ptr(), x.numel() // n, n, work.data_ptr(), scale.data_ptr(),
                             _stream(x))
    if err != 0:
        raise RuntimeError(f"act_absmax launch failed: cudaError_t {err}")
    absmax_launches += 1
    return scale


def _launch_taps(x: torch.Tensor, scale: torch.Tensor, kh: int, kw: int, stride: int, ph0: int,
                 ph1: int, pw0: int, pw1: int, k_pad: int) -> torch.Tensor:
    """The `int8_taps` kernel; returns A [max(N*Ho*Wo, 17), k_pad] int8."""
    global taps_launches
    from cspn_tpu_torch.ops import _build

    _check_activation(x, "int8_taps")
    n, c, h, w = x.shape
    f32, per_sample = _scale_code(scale, x, n, "int8_taps")
    ho, wo = out_hw(h, w, kh, kw, stride, ph0, ph1, pw0, pw1)
    if ho <= 0 or wo <= 0 or k_pad < kh * kw * c or k_pad % 8:
        raise ValueError(f"int8_taps: no [{ho}, {wo}] output or K' {k_pad} for {tuple(x.shape)} "
                         f"and a {kh}x{kw} kernel")
    rows = max(n * ho * wo, MIN_ROWS)
    a = torch.empty(rows, k_pad, dtype=torch.int8, device=x.device)
    lib = _build.load("int8_conv")
    with torch.cuda.device(x.device):
        err = lib.int8_taps(x.data_ptr(), scale.data_ptr(), f32, per_sample, a.data_ptr(), n, h, w,
                            c, kh, kw, stride, ph0, pw0, ho, wo, rows, k_pad, _stream(x))
    if err != 0:  # 1, cudaErrorInvalidValue: past the kernel's 32-bit indexing
        raise RuntimeError(f"int8_taps launch failed: cudaError_t {err}")
    taps_launches += 1
    return a


def _check_epilogue(bn: list | None, residual: torch.Tensor | None, relu: bool,
                    acc: torch.Tensor, shape: tuple[int, int, int, int]) -> None:
    """Raise on an epilogue the kernel does not take: BN parameters other
    than three bf16 [O] on the product's card, a residual or a ReLU without
    them, a residual other than the output's bf16 [N, O, Ho, Wo]."""
    if bn is None:
        if residual is not None or relu:
            raise ValueError("int8_dequant: the residual and the ReLU follow the BN, given none")
        return
    o = shape[1]
    got = [None if t is None else (t.dtype, tuple(t.shape), str(t.device)) for t in bn]
    if any(g != (torch.bfloat16, (o,), str(acc.device)) for g in got):
        raise ValueError(f"int8_dequant: the BN's (mean, mul, bias) are bf16 [{o}] on "
                         f"{acc.device}, got {got}")
    if residual is not None and (residual.dtype, tuple(residual.shape), residual.device) != (
            torch.bfloat16, shape, acc.device):
        raise ValueError(f"int8_dequant: the residual is bf16 {list(shape)} on {acc.device}, got "
                         f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")


def _launch_dequant(acc: torch.Tensor, scale: torch.Tensor, ws: torch.Tensor, n: int, ho: int,
                    wo: int, out_dtype: torch.dtype, bn: list | None = None,
                    residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """The `int8_dequant` kernel, with the epilogue where `bn` gives the
    BN's (mean, mul, bias); returns [n, ho, wo, O] bf16, contiguous."""
    global dequant_launches, dequant_bn_launches
    from cspn_tpu_torch.ops import _build

    if acc.dtype != torch.int32 or acc.ndim != 2:
        raise TypeError(f"int8_dequant takes the int32 [M', O'] product, got {acc.dtype} "
                        f"{tuple(acc.shape)}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"int8_dequant writes bf16, not {out_dtype}")
    o, m = ws.shape[0], n * ho * wo
    if ws.ndim != 1 or acc.shape[0] < m or acc.shape[1] < o or acc.shape[1] % 8:
        raise ValueError(f"int8_dequant: a product {tuple(acc.shape)} for {m} rows of "
                         f"{tuple(ws.shape)} channels")
    xs_f32, per_sample = _scale_code(scale, acc, n, "int8_dequant")
    ws_f32, _ = _scale_code(ws, acc, o, "int8_dequant")
    _check_epilogue(bn, residual, relu, acc, (n, o, ho, wo))
    acc, scale, ws = acc.contiguous(), scale.contiguous(), ws.contiguous()
    mean, mul, bias = (None,) * 3 if bn is None else (t.contiguous() for t in bn)
    if residual is not None:  # NHWC memory on a 16-byte boundary, as the output's
        residual = residual.contiguous(memory_format=torch.channels_last)
        if residual.data_ptr() % 16:
            residual = residual.clone(memory_format=torch.channels_last)
    out = torch.empty(n, ho, wo, o, dtype=torch.bfloat16, device=acc.device)
    lib = _build.load("int8_conv")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(acc.device):
        err = lib.int8_dequant(acc.data_ptr(), acc.shape[1], scale.data_ptr(), xs_f32, per_sample,
                               ws.data_ptr(), ws_f32, ptr(mean), ptr(mul), ptr(bias),
                               ptr(residual), int(relu), out.data_ptr(), m, ho * wo, o,
                               _stream(acc))
    if err != 0:
        raise RuntimeError(f"int8_dequant launch failed: cudaError_t {err}")
    dequant_launches += 1
    dequant_bn_launches += int(bn is not None)
    return out


@torch.library.custom_op("cspn_tpu_torch::act_absmax", mutates_args=(), device_types="cuda")
def act_absmax(x: torch.Tensor) -> torch.Tensor:
    """The per-sample scale of a bf16 activation [N, C, H, W], [N] bf16:
    its abs-max, clamped and divided by 127 as quantize_tensor forms it."""
    return _launch_absmax(x)


@act_absmax.register_fake
def _(x):
    return x.new_empty((x.shape[0],))


@torch.library.custom_op("cspn_tpu_torch::int8_taps", mutates_args=(), device_types="cuda")
def int8_taps(x: torch.Tensor, scale: torch.Tensor, kh: int, kw: int, stride: int, ph0: int,
              ph1: int, pw0: int, pw1: int, k_pad: int) -> torch.Tensor:
    """The int8 im2col of x [N, C, H, W] quantized by `scale` and padded by
    ((ph0, ph1), (pw0, pw1)) for a kh x kw conv of `stride`: [max(N * Ho *
    Wo, 17), k_pad] int8, columns in (kh, kw, C) order, zeros in the pad
    rows and columns."""
    return _launch_taps(x, scale, kh, kw, stride, ph0, ph1, pw0, pw1, k_pad)


@int8_taps.register_fake
def _(x, scale, kh, kw, stride, ph0, ph1, pw0, pw1, k_pad):
    n, _, h, w = x.shape
    ho, wo = out_hw(h, w, kh, kw, stride, ph0, ph1, pw0, pw1)
    return x.new_empty((torch.sym_max(n * ho * wo, MIN_ROWS), k_pad), dtype=torch.int8)


@torch.library.custom_op("cspn_tpu_torch::int8_dequant", mutates_args=(), device_types="cuda")
def int8_dequant(acc: torch.Tensor, scale: torch.Tensor, ws: torch.Tensor, n: int, ho: int,
                 wo: int, out_dtype: torch.dtype, mean: torch.Tensor | None = None,
                 mul: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """The int32 product [M', O'] of `int8_taps`' A, dequantized by the
    activation `scale` times the weight scales `ws` [O]: [n, ho, wo, O] in
    out_dtype, contiguous (NHWC; the conv's NCHW output is its permuted
    view).  With the eval BN's bf16 `mean`, `mul` and `bias` [O], its
    epilogue writes relu?(bn(y) [+ residual]) in their place, `residual`
    [n, O, ho, wo] bf16 in any layout."""
    bn = None if mean is None and mul is None and bias is None else [mean, mul, bias]
    return _launch_dequant(acc, scale, ws, n, ho, wo, out_dtype, bn, residual, relu)


@int8_dequant.register_fake
def _(acc, scale, ws, n, ho, wo, out_dtype, mean=None, mul=None, bias=None, residual=None,
      relu=False):
    return acc.new_empty((n, ho, wo, ws.shape[0]), dtype=out_dtype)
