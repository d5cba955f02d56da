"""int8 serving quantization of the conv stack (counterpart of
cspn_tpu/utils/quant.py).

Post-training quantization, the JAX package's scheme:
  - weights: symmetric int8 per output channel, scale = max|w| / 127 over
    (cin, kh, kw) -- an OIHW weight's dims 1-3;
  - activations: symmetric int8 per sample, dynamic (abs-max of each
    sample, computed at every call) or static (a per-site scale calibrated
    once at load, `build_act_calibration`: no reduce per call, saturating
    outside the calibrated range);
  - the conv multiplies s8 x s8 and sums in int32 (exact), then
    dequantizes as y * (x_scale * w_scale) into the activations' dtype
    (bf16 in the int8 model: cspn_tpu/train/loop.py:44-45).

Rounding is half to even (`torch.round`, as `jnp.round`), by dividing by
the scale, in the scale's own dtype, then clipping to +-127 (never -128),
so the quantized tensors equal the JAX package's bit for bit
(tests/test_torch_quant.py).

The int8 conv is no Pallas kernel in the JAX package
(`lax.conv_general_dilated` with int32 accumulation, quant.py:89-96, which
XLA fuses with the quantization), so here the product is a library call,
`torch._int_mm`: int8 x int8 -> int32 on the CPU and, through cuBLASLt, on
the card, on an im2col matrix of the quantized input.  `_int_mm` on CUDA
takes M > 16 rows and K, N multiples of 8; the rows and K are padded with
zeros where a shape falls short (M at a tiny map, K and N never at the
models' widths), and a shape `_int_mm` still refuses raises: no float conv
runs instead.

Around the product, two routes.  On the CPU the plain PyTorch one:
`quantize_tensor` (or `quantize_tensor_static`), im2col by strided slices
of the padded int8 input (`_taps`: one int8 copy of the taps; `F.unfold`
takes no int8 tensor), `int8_matmul`'s padding and the dequantization in
`int8_conv_prequant`.  On the card three hand-written kernels in their
place (ops/quant_cuda.py, csrc/int8_conv.cu; `int8_conv_kernels`): the
per-sample scale (`act_absmax`), the quantization, padding and im2col in
one pass (`int8_taps`, already padded for `_int_mm`) and the fused
dequantization (`int8_dequant`), 4 launches a conv product where the
PyTorch passes took ~14, with the same bits.  A CUDA activation must be
bf16 (the int8 model's); another dtype raises.

`QuantConv` is an `nn.Conv2d` with the same float `weight`, so state dicts
stay interchangeable with the float models; `quantize_convs` swaps a
model's convs for it.  `build_weight_qcache` quantizes every QuantConv's
weights once at load (the subpixel decoder's phase-split kernels each with
their own per-channel scales, as JAX's cache holds them); without the
cache a QuantConv quantizes its weight at every call, as JAX's does.
Serving only: `round` has no gradient, so the models refuse `quant` in
training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.fx.experimental.symbolic_shapes import statically_known_true

from cspn_tpu_torch.models.decoder import SubpixelUnpoolConv, _subpixel_convs
from cspn_tpu_torch.models.resnet import NormInPromotedDtype, conv_bn_pairs, norm_bf16
from cspn_tpu_torch.ops import quant_cuda
from cspn_tpu_torch.ops.d2s import depth_to_space2

# _int_mm on CUDA: more than 16 rows, K and N multiples of 8
_MIN_ROWS = quant_cuda.MIN_ROWS
_ALIGN = 8


def quantize_tensor(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic int8, per sample (dims 1-3) for a 4D tensor, else
    over the whole tensor: (q int8, scale in x's dtype) with x ~= q * scale."""
    scale = x.abs().amax(dim=(1, 2, 3), keepdim=True) if x.ndim == 4 else x.abs().amax()
    scale = scale.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_tensor_static(x: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with a calibrated scale: round and clip, no reduce."""
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per output channel of an OIHW weight: (q int8,
    scale [O] in w's dtype) with w ~= q * scale[:, None, None, None]."""
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    scale = torch.where(amax > 0, amax, 1.0) / 127.0
    q = torch.clamp(torch.round(w.float() / scale.view(-1, *[1] * (w.ndim - 1))), -127, 127)
    return q.to(torch.int8), scale


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def weight_matrix(wq: torch.Tensor) -> torch.Tensor:
    """An int8 OIHW weight as the [O', K'] matrix `int8_matmul` takes:
    rows in (kh, kw, cin) order, the taps' order of `_taps`, zero-padded
    to multiples of 8 (contiguous; its transpose is the column-major B)."""
    o = wq.shape[0]
    m = wq.permute(0, 2, 3, 1).reshape(o, -1)
    k = m.shape[1]
    return F.pad(m, (0, _pad_to(k, _ALIGN) - k, 0, _pad_to(o, _ALIGN) - o))


def int8_matmul(a: torch.Tensor, w_mat: torch.Tensor, n_out: int) -> torch.Tensor:
    """a [M, K] int8 times w_mat [O', K'] int8 (weight_matrix) transposed:
    [M, n_out] int32, exact.  Rows are padded to more than 16 and K to
    w_mat's K' with zeros, which add nothing.  Where M is symbolic (a
    batch dimension that `torch.export` keeps open) and not known to be
    large enough, the rows are padded by max(17 - M, 0) without a branch on
    M, which the trace could not keep."""
    m, k = a.shape
    if statically_known_true(m >= _MIN_ROWS):
        if k != w_mat.shape[1]:
            a = F.pad(a, (0, w_mat.shape[1] - k))
    else:
        a = F.pad(a, (0, w_mat.shape[1] - k, 0, torch.sym_max(_MIN_ROWS - m, 0)))
    return torch._int_mm(a, w_mat.t())[:m, :n_out]


def _taps(xq: torch.Tensor, k: tuple[int, int], stride: int,
          pad: tuple[tuple[int, int], tuple[int, int]]) -> tuple[torch.Tensor, int, int]:
    """im2col of an int8 NCHW input: [N * Ho * Wo, kh * kw * C] in (kh,
    kw, C) order, and (Ho, Wo)."""
    n, c, h, w = xq.shape
    (ph0, ph1), (pw0, pw1) = pad
    x = F.pad(xq.permute(0, 2, 3, 1), (0, 0, pw0, pw1, ph0, ph1))  # NHWC
    ho = (h + ph0 + ph1 - k[0]) // stride + 1
    wo = (w + pw0 + pw1 - k[1]) // stride + 1
    taps = [x[:, i : i + stride * (ho - 1) + 1 : stride, j : j + stride * (wo - 1) + 1 : stride]
            for i in range(k[0]) for j in range(k[1])]
    return torch.stack(taps, 3).reshape(n * ho * wo, k[0] * k[1] * c), ho, wo


def int8_conv_prequant(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                       stride: int, pad, out_dtype: torch.dtype,
                       w_mat: torch.Tensor | None = None) -> torch.Tensor:
    """The conv of a quantized input (xq int8 NCHW, xs its scale) with
    quantized weights (wq int8 OIHW, ws [O]; `w_mat` their cached
    weight_matrix): s8 x s8 -> s32, dequantized as y * (xs * ws) into
    `out_dtype`.  `pad` is ((lo, hi) of H, (lo, hi) of W).  Returns NCHW
    (a channels-last view)."""
    n, o = xq.shape[0], wq.shape[0]
    a, ho, wo = _taps(xq, wq.shape[2:], stride, pad)
    y = int8_matmul(a, weight_matrix(wq) if w_mat is None else w_mat, o).view(n, ho, wo, o)
    scale = xs.reshape(-1, 1, 1, 1) * ws
    return (y.float() * scale).to(out_dtype).permute(0, 3, 1, 2)


def int8_conv_kernels(x: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      stride: int, pad, w_mat: torch.Tensor | None = None, bn: tuple = (),
                      residual: torch.Tensor | None = None, relu: bool = False) -> torch.Tensor:
    """`int8_conv_prequant` on the card, from the unquantized bf16 input x
    (channels-last) and its scale xs: the taps quantized and padded by
    `int8_taps`, `_int_mm`, `int8_dequant`.  The same bits and the same
    NCHW view of an NHWC-contiguous output.  With `bn`, an eval BN's bf16
    (mean, mul, bias), `int8_dequant`'s epilogue writes relu?(norm_bf16(y,
    *bn) [+ residual]) in y's place."""
    (ph0, ph1), (pw0, pw1) = pad
    kh, kw = wq.shape[2:]
    w_mat = weight_matrix(wq) if w_mat is None else w_mat
    n, _, h, w = x.shape
    ho, wo = quant_cuda.out_hw(h, w, kh, kw, stride, ph0, ph1, pw0, pw1)
    a = torch.ops.cspn_tpu_torch.int8_taps(x, xs, kh, kw, stride, ph0, ph1, pw0, pw1,
                                           w_mat.shape[1])
    acc = torch._int_mm(a, w_mat.t())
    y = torch.ops.cspn_tpu_torch.int8_dequant(acc, xs, ws, n, ho, wo, x.dtype, *bn,
                                              residual=residual, relu=relu)
    return y.permute(0, 3, 1, 2)


def apply_epilogue(y: torch.Tensor, bn: tuple, residual: torch.Tensor | None,
                   relu: bool) -> torch.Tensor:
    """relu?(norm_bf16(y, *bn) [+ residual]) op by op: the PyTorch route's
    form of `int8_dequant`'s epilogue."""
    y = norm_bf16(y, *bn)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def _tiled(bn: tuple, channels: int) -> tuple:
    """A BN's [C] parameters for a product of `channels` outputs: as they
    are, or repeated for the reindexed subpixel conv's four phase groups,
    px-major (models/decoder.py:_subpixel_weights)."""
    return tuple(t if t.shape[0] == channels else t.repeat(channels // t.shape[0]) for t in bn)


class QuantConv(nn.Conv2d):
    """A bias-free conv with int8 execution: the `nn.Conv2d` parameter
    (OIHW `weight`) it replaces, quantized per output channel.

    `subpixel` makes it the decoder's `unpool2x -> crop -> conv` pair in its
    subpixel form (models/decoder.py:subpixel_unpool_conv): forward(x,
    oheight, owidth) runs the same convs on the int8 input -- the four
    exact phase kernels from 128 output channels, the zero-padded reindexed
    kernel below -- each quantized per its own output channels, one
    activation quantization shared by them, and `depth_to_space2` of the
    dequantized phases.

    `bn`, `residual` and `relu` (models/resnet.py:conv_bn) make forward
    return relu?(bn(conv) [+ residual]), `bn` an eval BN's bf16 (mean, mul,
    bias): on the card in `int8_dequant`'s epilogue, a subpixel conv's on
    each phase before `depth_to_space2` (per channel and per value, the BN
    and ReLU commute with it; no residual reaches one).

    `qcache` holds the load-time weight cache (`build_weight_qcache`):
    [(wq, ws, weight_matrix(wq))] a conv; without it the weight is
    quantized at every call.  `act_max` holds the calibrated abs-max of the
    input (`build_act_calibration`), making the activation scale static;
    while `calibrating`, each call records it and quantizes dynamically.
    Both are buffers outside the state dict (`qcache_<i>_<wq|ws|mat>`,
    `act_max`): checkpoints stay the float models', while `named_buffers`,
    `torch.func.functional_call` and `torch.export` see them as the
    module's tensors (export.py embeds them with the weights or takes them
    as inputs), not as constants baked into a graph."""

    fuses_bn = True  # models/resnet.py:bn_epilogue

    def __init__(self, conv: nn.Conv2d, subpixel: bool = False):
        super().__init__(conv.in_channels, conv.out_channels, conv.kernel_size,
                         stride=conv.stride, padding=conv.padding, bias=False,
                         device="meta")
        if conv.bias is not None or conv.groups != 1 or conv.dilation != (1, 1):
            raise ValueError(f"{conv}: only bias-free, ungrouped, undilated convs are quantized")
        self.weight = conv.weight  # the same parameter: state dict keys and values stay
        self.subpixel = subpixel
        self._qcache_len = 0
        self.register_buffer("act_max", None, persistent=False)
        self.calibrating = False

    _QCACHE_PARTS = ("wq", "ws", "mat")

    @property
    def qcache(self) -> list | None:
        if not self._qcache_len:
            return None
        return [tuple(getattr(self, f"qcache_{i}_{part}") for part in self._QCACHE_PARTS)
                for i in range(self._qcache_len)]

    @qcache.setter
    def qcache(self, cache: list | None) -> None:
        for i in range(self._qcache_len):
            for part in self._QCACHE_PARTS:
                delattr(self, f"qcache_{i}_{part}")
        self._qcache_len = len(cache or ())
        for i, entry in enumerate(cache or ()):
            for part, t in zip(self._QCACHE_PARTS, entry):
                self.register_buffer(f"qcache_{i}_{part}", t, persistent=False)

    def _convs(self, w: torch.Tensor) -> list:
        """(kernel, (lo, hi) of H, (lo, hi) of W) of each conv this module runs."""
        if self.subpixel:
            return _subpixel_convs(w)
        p = self.padding
        return [(w, (p[0], p[0]), (p[1], p[1]))]

    def quantized_weights(self) -> list:
        """[(wq, ws, weight_matrix(wq))] of `_convs`, from the cache when built."""
        if self.qcache is not None:
            return self.qcache
        return [(*q, None) for q in (quantize_weights(k) for k, _, _ in self._convs(self.weight))]

    def _static_scale(self, x: torch.Tensor) -> torch.Tensor | None:
        """The calibrated activation scale, or None for a dynamic one;
        while calibrating, records x's abs-max first."""
        if self.calibrating:
            amax = x.abs().amax().float()
            self.act_max = amax if self.act_max is None else torch.maximum(self.act_max, amax)
        elif self.act_max is not None:
            return self.act_max.clamp_min(1e-12) / 127.0
        return None

    def _products_plain(self, x: torch.Tensor, scale: torch.Tensor | None, convs, bn: tuple = (),
                        residual: torch.Tensor | None = None, relu: bool = False) -> list:
        """Each conv's output by the PyTorch route, one quantization of x,
        then the epilogue where `bn` gives one, op by op."""
        xq, xs = quantize_tensor(x) if scale is None else quantize_tensor_static(x, scale)
        ys = [int8_conv_prequant(xq, xs, wq, ws, self.stride[0], pad, x.dtype, w_mat)
              for (wq, ws, w_mat), pad in convs]
        return [apply_epilogue(y, _tiled(bn, y.shape[1]), residual, relu) if bn else y
                for y in ys]

    def _products_kernels(self, x: torch.Tensor, scale: torch.Tensor | None, convs,
                          bn: tuple = (), residual: torch.Tensor | None = None,
                          relu: bool = False) -> list:
        """Each conv's output by the card's kernels, one scale of x and, where
        x is not channels-last already, one copy into that layout for all of
        them; the epilogue where `bn` gives one in `int8_dequant`, the
        residual copied into channels-last where it is not."""
        x = x.contiguous(memory_format=torch.channels_last)
        if residual is not None:
            residual = residual.contiguous(memory_format=torch.channels_last)
        xs = torch.ops.cspn_tpu_torch.act_absmax(x) if scale is None else scale
        return [int8_conv_kernels(x, xs, wq, ws, self.stride[0], pad, w_mat,
                                  _tiled(bn, wq.shape[0]), residual, relu)
                for (wq, ws, w_mat), pad in convs]

    def forward(self, x: torch.Tensor, oheight: int | None = None, owidth: int | None = None,
                bn: tuple = (), residual: torch.Tensor | None = None, relu: bool = False):
        if (residual is not None or relu) and not bn or residual is not None and self.subpixel:
            raise ValueError("a QuantConv's residual and ReLU follow its BN, and no residual "
                             "follows a subpixel one")
        scale = self._static_scale(x)
        pads = [(ph, pw) for _, ph, pw in self._convs(self.weight)]
        products = self._products_kernels if x.is_cuda else self._products_plain
        ys = products(x, scale, zip(self.quantized_weights(), pads), tuple(bn), residual, relu)
        if not self.subpixel:
            return ys[0]
        return depth_to_space2(ys[0] if len(ys) == 1 else ys, oheight, owidth)


def quantize_convs(module: nn.Module) -> nn.Module:
    """`module` with every conv in it swapped for a QuantConv holding the
    same weight (models/decoder.py's SubpixelUnpoolConv for a subpixel
    one); returns the module, or its QuantConv if it is a conv itself."""
    if isinstance(module, QuantConv):
        return module
    if isinstance(module, nn.Conv2d):
        return QuantConv(module, isinstance(module, SubpixelUnpoolConv))
    for name, child in module.named_children():
        module.add_module(name, quantize_convs(child))
    return module


def quant_convs(model: nn.Module) -> dict[str, QuantConv]:
    """The model's QuantConvs by module name."""
    return {k: m for k, m in model.named_modules() if isinstance(m, QuantConv)}


def kernel_launches(model: nn.Module) -> dict[str, int]:
    """The int8 kernels' launches (ops/quant_cuda.py) in one forward of
    `model` on the card: `act_absmax` a QuantConv with dynamic scales,
    `int8_taps` and `int8_dequant` a conv product (a subpixel conv's four
    phases four), and `int8_dequant_bn` the products of `int8_dequant`
    with the BN epilogue: those of each QuantConv that a block pairs with
    an eval BN normalizing bf16 (models/resnet.py:conv_bn)."""
    convs = quant_convs(model).values()
    products = sum(len(m._convs(m.weight)) for m in convs)
    fused = sum(len(c._convs(c.weight)) for c, bn in conv_bn_pairs(model)
                if isinstance(c, QuantConv) and isinstance(bn, NormInPromotedDtype)
                and bn.bf16_params(torch.bfloat16) is not None)
    return {"act_absmax": sum(m.act_max is None for m in convs), "int8_taps": products,
            "int8_dequant": products, "int8_dequant_bn": fused}


@torch.no_grad()
def build_weight_qcache(model: nn.Module) -> dict[str, list]:
    """Quantize every QuantConv's weights once (at serving load) into its
    `qcache`; returns {module name: qcache}, a conv's kernels in `_convs`
    order (the subpixel decoder's phase kernels px-major, as JAX's cache)."""
    convs = quant_convs(model)
    for m in convs.values():
        m.qcache = None  # quantize the weight as it is now
        m.qcache = [(wq, ws, weight_matrix(wq)) for wq, ws, _ in m.quantized_weights()]
    return {name: m.qcache for name, m in convs.items()}


@torch.inference_mode()
def build_act_calibration(model: nn.Module, batches) -> dict[str, torch.Tensor]:
    """Calibrate static per-site activation scales: run `batches` through
    the model recording each QuantConv input's abs-max (the calibration
    pass itself quantizes dynamically); returns {module name: abs-max}, the
    JAX package's 'acal' collection.  Later calls quantize with the static
    scales."""
    convs = quant_convs(model)
    for m in convs.values():
        m.act_max, m.calibrating = None, True
    try:
        n = 0
        for xb in batches:
            model(xb)
            n += 1
        if n == 0:
            raise ValueError("calibration needs at least one batch")
    finally:
        for m in convs.values():
            m.calibrating = False
    return {k: m.act_max for k, m in convs.items()}
