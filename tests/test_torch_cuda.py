"""The CUDA kernels -- the 2D CSPN forwards (the one keeping its states
for the backward, and the tiled one) and backward, the sharded 2D CSPN's segment and its backward, the
paddle-semantics 2D CSPN, the 3D CSPN forward and backward,
the subpixel decoder's depth-to-space and its adjoint, the step-body probe,
the int8 conv's abs-max, taps and dequantization -- against their plain
versions, on the card; and the serving graphs (one CUDA graph a bucket)
against the eager server.

Marked `cuda`: without a card every test here skips.  On a machine with
one (and without JAX, which tests/conftest.py imports) run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-4 x max|plain| (FMA contraction and summation order differ),
for the output and for each gradient; the depth-to-space kernels move
values and the int8 conv's kernels equal the PyTorch route's passes on
the same card, both held bit for bit, and the tiled 2D forward to the
states-keeping one's values and, on bf16 inputs or float32 ones rounded in
registers, to its own values on `_round_io`'s inputs; the probe's bf16-state pair within 1e-2 x max|plain| (its
bf16 FMA rounds once where the plain version may round twice).
"""

import pytest
import torch

from cspn_tpu_torch.ops import _build, cspn3d_cuda, cspn_cuda, cspn_paddle2d_cuda, cspn_ref, d2s
from cspn_tpu_torch.ops.cspn import cspn2d, cspn_nd
from cspn_tpu_torch.utils import step_probe

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, n, h, w, with_sparse=True):
    g = torch.randn(n, 8, h, w, device="cuda", generator=gen)
    b = torch.rand(n, h, w, device="cuda", generator=gen) * 5
    s = None
    if with_sparse:
        s = torch.where(torch.rand(n, h, w, device="cuda", generator=gen) < 0.05,
                        torch.randn(n, h, w, device="cuda", generator=gen), 0.0)
    return g, b, s


def _plain(g_cf, b, s, steps, norm_type):
    return cspn_ref.cspn2d_reference(g_cf.movedim(1, -1), b, s, steps=steps, norm_type=norm_type)


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 2, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13, 17), (3, 33, 65), (2, 228, 304)])
def test_kernel_matches_plain(gen, shape, steps, with_sparse, norm_type):
    g, b, s = _inputs(gen, *shape, with_sparse)
    before = cspn_cuda.launches
    got = cspn_cuda._launch(g, b, s, steps, norm_type)[0]  # the forward keeping its states
    torch.cuda.synchronize()
    assert cspn_cuda.launches == before + 1
    want = _plain(g, b, s, steps, norm_type)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def test_zero_gates_and_channels_last(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    g[0, :, 4:9, 4:9] = 0.0
    got = cspn2d(g.movedim(1, -1), b, s, steps=24)  # NHWC guidance, backend auto
    want = _plain(g, b, s, 24, "8sum")
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def test_bf16_io_rounds_inputs(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    got = cspn_cuda.cspn2d_cuda(g, b, s, steps=8, channel_first=True, io_dtype=torch.bfloat16)
    r = [t.to(torch.bfloat16).float() for t in (g, b, s)]
    want = _plain(*r, 8, "8sum")
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def test_wrapper_refuses_what_the_kernel_does_not_take(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    with pytest.raises(TypeError):
        cspn_cuda.cspn2d_cuda(g.double(), b, s, channel_first=True)
    with pytest.raises(ValueError, match="contiguous"):
        cspn_cuda.cspn2d_cuda(g, b.transpose(1, 2).contiguous().transpose(1, 2), s, channel_first=True)
    with pytest.raises(ValueError, match=r"must be \[2,13,17\]"):
        cspn_cuda.cspn2d_cuda(g, b[:, :12].contiguous(), None, channel_first=True)
    with pytest.raises(ValueError, match=r"\[N,8,H,W\]"):
        cspn_cuda.cspn2d_cuda(g[:, :7], b, s, channel_first=True)
    with pytest.raises(ValueError, match="norm_type"):
        cspn_cuda.cspn2d_cuda(g, b, s, channel_first=True, norm_type="8max")
    with pytest.raises(ValueError, match="on cpu"):
        cspn_cuda.cspn2d_cuda(g, b.cpu(), s, channel_first=True)


def _grads(fn, g, b, s, ct):
    g, b = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
    dg, db = torch.autograd.grad((fn(g, b, s) * ct).sum(), (g, b), allow_unused=True)
    return torch.zeros_like(g) if dg is None else dg, db  # steps=0: the plain output is blur


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 2, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13, 17), (3, 33, 65), (2, 228, 304),
                                   (2, 75, 101), (4, 352, 1216)])
def test_backward_kernel_matches_plain(gen, shape, steps, with_sparse, norm_type):
    g, b, s = _inputs(gen, *shape, with_sparse)
    g[0, :, :5, :5] = 0.0  # zero gates (and zero guidance) in one corner
    ct = torch.randn(shape, device="cuda", generator=gen)
    before = cspn_cuda.bwd_launches
    got = _grads(lambda g, b, s: cspn_cuda.cspn2d_cuda(g, b, s, steps=steps, norm_type=norm_type,
                                                         channel_first=True), g, b, s, ct)
    torch.cuda.synchronize()
    assert cspn_cuda.bwd_launches == before + 1
    want = _grads(lambda g, b, s: _plain(g, b, s, steps, norm_type), g, b, s, ct)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - w).abs().max().item() <= TOL * max(w.abs().max().item(), 1e-30)


def test_backward_takes_strided_cotangents_and_unrounded_residuals(gen):
    g, b, s = _inputs(gen, 2, 13, 17)
    w = torch.randn(2, 17, 13, device="cuda", generator=gen)

    def loss(io_dtype):  # the cotangent reaches the kernel transposed
        def fn(g, b, s):
            return cspn_cuda.cspn2d_cuda(g, b, s, steps=8, channel_first=True, io_dtype=io_dtype)
        return lambda g, b, s: fn(g, b, s).transpose(1, 2) * w

    ones = torch.ones(2, 17, 13, device="cuda")
    got = _grads(loss(None), g, b, s, ones)
    want = _grads(lambda g, b, s: _plain(g, b, s, 8, "8sum").transpose(1, 2) * w, g, b, s, ones)
    for a, x in zip(got, want):
        assert (a - x).abs().max().item() <= TOL * x.abs().max().item()
    # bf16 I/O rounds the forward's inputs only: the backward is the adjoint
    # of the f32 function at the unrounded inputs, as the JAX custom VJP
    for a, x in zip(_grads(loss(torch.bfloat16), g, b, s, ones), got):
        assert torch.equal(a, x)


def test_train_step_on_the_card_launches_both_kernels(gen):
    """A resnet18 train step through the kernels launches each once; its
    gradients are as close to the float64 plain step as the float32 plain
    step's (chip_smoke.py's criterion: 1e-3 x max, or 8x the plain step's
    own distance), with deterministic cuDNN and the ground truth 1 to 2 away
    from every prediction (no L1 sign flips)."""
    from cspn_tpu_torch.models import unet
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(2, 64, 96, 4, device="cuda", generator=gen)
    grads = {}
    torch.backends.cudnn.deterministic = True
    try:
        for backend, dtype in (("kernel", torch.float32), ("reference", torch.float32),
                               ("reference", torch.float64)):
            model = unet.cspn_unet_resnet18(cspn_steps=4, cspn_backend=backend,
                                            generator=torch.Generator().manual_seed(0))
            model = model.to("cuda", dtype)
            if backend == "kernel":  # ground truth 1 to 2 from each prediction, either side
                with torch.no_grad():
                    pred = model(x)
                side = torch.where(torch.rand(pred.shape, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
                depth = pred + side * (1.0 + torch.rand(pred.shape, device="cuda", generator=gen))
            step = make_train_step(model, make_optimizer(model.parameters()))
            before = (cspn_cuda.launches, cspn_cuda.bwd_launches)
            loss, error = step(x.to(dtype), depth.to(dtype))
            torch.cuda.synchronize()
            launched = (cspn_cuda.launches - before[0], cspn_cuda.bwd_launches - before[1])
            assert launched == ((1, 1) if backend == "kernel" else (0, 0))
            assert torch.isfinite(loss) and torch.isfinite(error["RMSE"])
            grads[backend, dtype] = {k: p.grad.double() for k, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic = False
    kernel, plain = grads["kernel", torch.float32], grads["reference", torch.float32]
    for k, g64 in grads["reference", torch.float64].items():
        d_k, d_r = (kernel[k] - g64).abs().max().item(), (plain[k] - g64).abs().max().item()
        assert d_k <= 1e-3 * g64.abs().max().item() or d_k <= 8 * d_r, k


def test_entry_points_on_the_card_turn_on_cudnn_timing(gen, monkeypatch, tmp_path):
    """The Trainer sets cuDNN's algorithm timing for the card; building a
    model alone leaves the policy as it finds it."""
    import dataclasses

    from cspn_tpu_torch.config import PRESETS
    from cspn_tpu_torch.train.evaluate import build_model
    from cspn_tpu_torch.train.loop import Trainer

    cfg = dataclasses.replace(PRESETS["synthetic_smoke"], save_dir=str(tmp_path))
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    build_model(cfg, device="cuda")
    assert torch.backends.cudnn.benchmark is False
    Trainer(cfg, None, None, device="cuda")
    assert torch.backends.cudnn.benchmark is True
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


def test_model_on_the_card_uses_the_kernel(gen):
    from cspn_tpu_torch.models import unet

    torch.backends.cudnn.allow_tf32 = False
    model = unet.cspn_unet_resnet18(cspn_steps=4, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.randn(2, 64, 96, 4, device="cuda", generator=gen)
    before = cspn_cuda.tiled_launches
    with torch.inference_mode():
        got = model(x)
        model.cspn_backend = "reference"
        want = model(x)
    assert cspn_cuda.tiled_launches == before + 1
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


# --- the 3D CSPN kernels (csrc/cspn3d_fwd.cu, csrc/cspn3d_bwd.cu) ---------


def _gates3d(gen, m, d, h, w, zero_corner=False):
    """Normalized gates [m,26,d,h,w] from random guidance; all-zero gates
    (the 1e-12 guard: centre weight 1) in one corner when asked."""
    g = torch.randn(m, 26, d, h, w, device="cuda", generator=gen)
    if zero_corner:
        g[0, :, :2, :3, :4] = 0.0
    a = g.abs()
    return a / a.sum(1, keepdim=True).clamp_min(1e-12)


def _plain_grads3d(gates, x0, ct, steps):
    gp, xp = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    want = cspn_ref.propagate_nd_reference(gp, xp, steps)
    want_grads = torch.autograd.grad(want, (gp, xp), ct, allow_unused=True)
    return want, (torch.zeros_like(gates) if want_grads[0] is None else want_grads[0],
                  want_grads[1])


# volumes smaller than one block (the first two), odd ones, the stereo b4
# volume, the sharded stereo segment (S = 2, K = 8: D / 2 + 2K deep), and one
# whose gates exceed the chip: 20 of its 26 planes are read from L2 each step
@pytest.mark.parametrize("steps", [0, 1, 2, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 2, 3, 4), (4, 5, 13, 17), (2, 12, 16, 32),
                                   (4, 48, 64, 128), (8, 40, 64, 128), (1, 96, 64, 128)])
def test_cspn3d_kernels_match_plain(gen, shape, steps):
    gates = _gates3d(gen, *shape, zero_corner=True)
    x0 = torch.randn(shape, device="cuda", generator=gen)
    ct = torch.randn(shape, device="cuda", generator=gen)
    before = (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches)
    gk, xk = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    got = cspn3d_cuda.propagate3d(gk, xk, steps=steps)
    got_grads = torch.autograd.grad(got, (gk, xk), ct)
    torch.cuda.synchronize()
    assert (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    want, want_grads = _plain_grads3d(gates, x0, ct, steps)
    for a, b in ((got, want), *zip(got_grads, want_grads)):
        assert a.shape == b.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL * max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("steps", [0, 1, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (4, 5, 13, 17), (4, 48, 64, 128),
                                   (1, 96, 64, 128)])
def test_cspn3d_kernels_on_bf16_gates_match_plain(gen, shape, steps):
    """gate_dtype bfloat16: the kernels on the gates rounded to bf16 (all 26
    planes on chip at the stereo volume; the looping sweep at 96 deep)
    against the plain sweep on the same rounding, forward and backward."""
    gates = _gates3d(gen, *shape, zero_corner=True)
    x0 = torch.randn(shape, device="cuda", generator=gen)
    ct = torch.randn(shape, device="cuda", generator=gen)
    gk, xk = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    got = cspn3d_cuda.propagate3d(gk, xk, steps=steps, gate_dtype=torch.bfloat16)
    got_grads = torch.autograd.grad(got, (gk, xk), ct)
    gp, xp = gates.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    want = cspn3d_cuda.propagate3d_reference(gp, xp, steps=steps, gate_dtype=torch.bfloat16)
    # at 0 steps the plain version reads no gate: their gradient is zero
    want_grads = torch.autograd.grad(want, (gp, xp), ct, allow_unused=True,
                                     materialize_grads=True)
    torch.cuda.synchronize()
    for a, b in ((got, want), *zip(got_grads, want_grads)):
        assert a.shape == b.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL * max(b.abs().max().item(), 1e-30)


def test_int8_matmul_on_the_card(gen):
    """torch._int_mm through quant.int8_matmul on CUDA: exact int32 sums,
    rows padded past 16 (a 5-row product) and K, N to multiples of 8."""
    from cspn_tpu_torch.utils import quant

    a = torch.randint(-127, 128, (100, 72), dtype=torch.int8, device="cuda", generator=gen)
    wq = torch.randint(-127, 128, (20, 8, 3, 3), dtype=torch.int8, device="cuda", generator=gen)
    w_mat = quant.weight_matrix(wq)
    want = a.double() @ wq.permute(0, 2, 3, 1).reshape(20, -1).double().t()
    for rows in (100, 5):
        got = quant.int8_matmul(a[:rows], w_mat, 20)
        assert got.dtype == torch.int32 and torch.equal(got.double(), want[:rows])


# --- the int8 conv's kernels (ops/quant_cuda.py) against the PyTorch route on the card ---

# (C, O, kernel, stride, padding, subpixel, N, H, W): 1x1 at stride 1 and 2,
# 3x3 at stride 1 and 2, a subpixel 5x5 (four phase kernels), a map of
# fewer than 17 output pixels, C = 8 and 24, C = 5 (the scalar path), and
# two of the nyu CSPN-UNet's own at b8
INT8_GEOMETRIES = {
    "1x1": (32, 24, 1, 1, 0, False, 2, 5, 7),
    "1x1_s2": (16, 40, 1, 2, 0, False, 2, 7, 9),
    "3x3": (16, 24, 3, 1, 1, False, 2, 5, 7),
    "3x3_s2": (32, 16, 3, 2, 1, False, 2, 7, 9),
    "subpixel_5x5": (16, 128, 5, 1, 2, True, 2, 5, 7),
    "few_rows": (16, 8, 3, 2, 1, False, 1, 4, 5),
    "c8": (8, 16, 3, 1, 1, False, 2, 5, 7),
    "c24": (24, 16, 3, 1, 1, False, 2, 5, 7),
    "c5": (5, 12, 3, 1, 1, False, 2, 5, 7),
    "layer1_3x3_b8": (64, 64, 3, 1, 1, False, 8, 57, 76),
    "decoder_subpixel_b8": (1024, 128, 5, 1, 2, True, 8, 15, 19),
    "subpixel_5x5_joined": (16, 64, 5, 1, 2, True, 2, 5, 7),  # one reindexed kernel
}


def _int8_conv(gen, c, o, k, stride, pad, subpixel, static):
    from cspn_tpu_torch.utils import quant

    conv = torch.nn.Conv2d(c, o, k, stride=stride, padding=pad, bias=False, device="cuda")
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, device="cuda", generator=gen))
    qc = quant.QuantConv(conv, subpixel=subpixel).to(torch.bfloat16)
    quant.build_weight_qcache(qc)
    if static:
        qc.act_max = torch.tensor(2.5, device="cuda")
    return qc


def _int8_launches():
    from cspn_tpu_torch.ops import quant_cuda

    return (quant_cuda.absmax_launches, quant_cuda.taps_launches, quant_cuda.dequant_launches,
            quant_cuda.dequant_bn_launches)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("geometry", list(INT8_GEOMETRIES))
def test_int8_kernels_equal_the_pytorch_route(gen, geometry, channels_last, static):
    """act_absmax, int8_taps and int8_dequant against the PyTorch route's
    passes on the same card, bit for bit: the scale (quantize_tensor's),
    A (`_taps` of the quantized input, padded as int8_matmul pads it), each
    conv's output (int8_conv_prequant's, same strides) and the QuantConv's
    output; one launch of each a conv product (act_absmax one a QuantConv,
    none on a static scale).  The ops take the channels-last copy, the
    QuantConv the input in either layout.  Sample 0 is zero (the clamped
    scale)."""
    import torch.nn.functional as F

    from cspn_tpu_torch.utils import quant

    c, o, k, stride, pad, sub, n, h, w = INT8_GEOMETRIES[geometry]
    qc = _int8_conv(gen, c, o, k, stride, pad, sub, static)
    x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
    if n > 1:
        x[0] = 0
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    oh, ow = (2 * h - 1, 2 * w) if sub else (None, None)
    scale = qc._static_scale(x)
    pads = [(ph, pw) for _, ph, pw in qc._convs(qc.weight)]
    convs = list(zip(qc.quantized_weights(), pads))
    x_cl = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        xq, xs = quant.quantize_tensor(x) if scale is None else quant.quantize_tensor_static(x, scale)
        before = _int8_launches()
        ks = torch.ops.cspn_tpu_torch.act_absmax(x_cl) if scale is None else scale
        assert torch.equal(ks.reshape(-1), xs.reshape(-1)) and ks.dtype == xs.dtype
        for (wq, ws, wm), (ph, pw) in convs:
            a = torch.ops.cspn_tpu_torch.int8_taps(x_cl, ks, *wq.shape[2:], stride, *ph, *pw,
                                                   wm.shape[1])
            taps, ho, wo = quant._taps(xq, wq.shape[2:], stride, (ph, pw))
            rows = taps.shape[0]
            want_a = F.pad(taps, (0, wm.shape[1] - taps.shape[1], 0, max(17 - rows, 0)))
            assert a.dtype == torch.int8 and torch.equal(a, want_a)
            acc = torch._int_mm(a, wm.t())
            y = torch.ops.cspn_tpu_torch.int8_dequant(acc, ks, ws, n, ho, wo, torch.bfloat16)
            want_y = quant.int8_conv_prequant(xq, xs, wq, ws, stride, (ph, pw), torch.bfloat16, wm)
            got_y = y.permute(0, 3, 1, 2)
            assert torch.equal(got_y, want_y) and got_y.stride() == want_y.stride()
        dynamic = int(scale is None)
        assert _int8_launches() == (before[0] + dynamic, before[1] + len(convs),
                                    before[2] + len(convs), before[3])
        got = qc(x, oh, ow)
        plain = qc._products_plain(x, scale, convs)
        want = plain[0] if not sub else quant.depth_to_space2(
            plain[0] if len(plain) == 1 else plain, oh, ow)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_int8_kernels_round_ties_to_even_and_clamp(gen):
    """Values on the half steps of the scale: a sample whose abs-max is 127
    has the scale bf16(127 * fl(1/127)) = 1, so x / 1 = x and k + 0.5
    rounds to the even neighbour, as torch.round does; values past the
    calibrated range clip to +-127 on the static route."""
    from cspn_tpu_torch.utils import quant

    x = torch.randint(-254, 255, (2, 16, 6, 8), device="cuda", generator=gen).float() / 2
    x[:, 0, 0, 0] = 127.0
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    xq, xs = quant.quantize_tensor(x)
    ks = torch.ops.cspn_tpu_torch.act_absmax(x)
    assert torch.equal(ks, xs.reshape(-1)) and (ks == 1).all()
    for scale in (ks, torch.tensor(0.25, device="cuda")):  # the static scale saturates
        want, _ = quant.quantize_tensor_static(x, scale.reshape(-1, 1, 1, 1))
        a = torch.ops.cspn_tpu_torch.int8_taps(x, scale, 1, 1, 1, 0, 0, 0, 0, 16)
        assert torch.equal(a, want.permute(0, 2, 3, 1).reshape(-1, 16))
    assert (a.abs() == 127).any()


def test_int8_taps_quantize_every_bf16_value_as_ieee_division(gen):
    """Every finite bf16 value, divided by 256 bf16 scales (one a sample:
    abs-maxima over 127 as act_absmax forms them, and bf16 values from
    2^-40 to 2^40) and by 32 float32 ones (the static route): the taps
    equal clamp(round(x.float() / scale), -127, 127) bit for bit."""
    bits = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16)
    values = bits.view(torch.bfloat16)
    values = values[torch.isfinite(values)]
    x = torch.zeros(65536, dtype=torch.bfloat16, device="cuda")
    x[: values.numel()] = values
    x = x.view(1, 64, 64, 16).expand(256, -1, -1, -1).permute(0, 3, 1, 2)  # NHWC memory
    amax = torch.rand(128, device="cuda", generator=gen) * 1e3
    wide = 2.0 ** (torch.rand(128, device="cuda", generator=gen) * 80 - 40)
    scales = torch.cat([amax.to(torch.bfloat16) / 127.0, wide.to(torch.bfloat16)])
    x = x.contiguous(memory_format=torch.channels_last)
    a = torch.ops.cspn_tpu_torch.int8_taps(x, scales, 1, 1, 1, 0, 0, 0, 0, 16)
    want = torch.clamp(torch.round(x.float() / scales.view(-1, 1, 1, 1)), -127, 127)
    assert torch.equal(a, want.to(torch.int8).permute(0, 2, 3, 1).reshape(-1, 16))
    for scale in 2.0 ** (torch.rand(32, device="cuda", generator=gen) * 60 - 30):
        a = torch.ops.cspn_tpu_torch.int8_taps(x[:1], scale, 1, 1, 1, 0, 0, 0, 0, 16)
        want = torch.clamp(torch.round(x[:1].float() / scale), -127, 127).to(torch.int8)
        assert torch.equal(a, want.permute(0, 2, 3, 1).reshape(-1, 16))


def test_int8_kernels_in_a_cuda_graph(gen):
    """A QuantConv's three ops captured in one CUDA graph (the abs-max's
    zeroing memset with them) replay on new inputs to the eager PyTorch
    route's output bit for bit; a replay counts one launch of each."""
    from cspn_tpu_torch import serving

    qc = _int8_conv(gen, 64, 64, 3, 1, 1, False, False)
    x = torch.randn(8, 64, 57, 76, device="cuda", generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        graph, out, per_replay = serving.capture_graph(lambda: qc(x), x.device)
        counts = {a: v for (_, a), v in per_replay.items() if v}
        assert counts == {"absmax_launches": 1, "taps_launches": 1, "dequant_launches": 1}
        for seed in range(3):
            x.copy_(torch.randn(x.shape, device="cuda", generator=gen) * (seed + 1))
            graph.replay()
            scale = qc._static_scale(x)
            convs = list(zip(qc.quantized_weights(), [((1, 1), (1, 1))]))
            want = qc._products_plain(x, scale, convs)[0]
            torch.cuda.synchronize()
            assert torch.equal(out, want)


@pytest.mark.parametrize("batch, static", [(1, False), (8, False), (8, True)],
                         ids=["b1", "b8", "b8_static"])
def test_int8_model_equals_the_pytorch_route(gen, batch, static, monkeypatch):
    """The whole int8 CSPN-UNet (nyu_eval: ResNet-50, 228x304) on the
    kernels equals it on the PyTorch route, bit for bit; one forward
    launches act_absmax 64 times (0 on static scales), int8_taps and
    int8_dequant 82, each with the BN epilogue (quant.kernel_launches),
    where the PyTorch route runs the BNs, adds and ReLUs as ops."""
    import dataclasses

    from cspn_tpu_torch import config
    from cspn_tpu_torch.train import evaluate
    from cspn_tpu_torch.utils import quant
    from cspn_tpu_torch.utils.precision import cast_floating

    cfg = config.PRESETS["nyu_eval"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="int8"))
    model = evaluate.build_model(cfg, device="cuda")
    model.load_state_dict(cast_floating(model.state_dict()), assign=True)
    quant.build_weight_qcache(model)
    x = torch.randn(batch, 228, 304, 4, device="cuda", generator=gen)
    if static:
        quant.build_act_calibration(model, [x])
    want_launches = quant.kernel_launches(model)
    assert want_launches == {"act_absmax": 0 if static else 64, "int8_taps": 82,
                             "int8_dequant": 82, "int8_dequant_bn": 82}
    with torch.no_grad():
        before = _int8_launches()
        got = model(x)
        after = _int8_launches()
        monkeypatch.setattr(quant.QuantConv, "_products_kernels", quant.QuantConv._products_plain)
        want = model(x)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(after, before)] == list(want_launches.values())
    assert _int8_launches() == after  # the PyTorch route launches none of them
    assert torch.equal(got, want)


# the epilogue's residual (None, or its layout) and ReLU
INT8_EPILOGUES = {"bn": (None, False), "bn_relu": (None, True),
                  "bn_residual_nhwc": ("nhwc", False), "bn_residual_nchw_relu": ("nchw", True),
                  "bn_residual_nhwc_relu": ("nhwc", True)}


def _serving_bn(gen, c, special=True):
    """An eval BatchNorm2d [c] holding bf16 serving weights with seeded
    statistics; with `special`, channels whose parameters are NaN, +-inf,
    -0 and a negative weight over a zero mean and a -0 bias (a zero input
    gives -0 before the ReLU)."""
    from cspn_tpu_torch.models.resnet import BatchNorm2d

    bn = BatchNorm2d(c, device="cuda")
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, device="cuda", generator=gen) * 0.1)
        bn.running_var.copy_(torch.rand(c, device="cuda", generator=gen) + 0.5)
        bn.weight.copy_(torch.randn(c, device="cuda", generator=gen))
        bn.bias.copy_(torch.randn(c, device="cuda", generator=gen) * 0.1)
        if special:
            bn.running_mean[0] = float("nan")
            bn.weight[1] = float("inf")
            bn.bias[2] = float("-inf")
            bn.running_mean[3], bn.weight[3], bn.bias[3] = 0.0, -1.5, -0.0
            bn.running_mean[4], bn.bias[4] = -0.0, -0.0
    return bn.to(torch.bfloat16).eval()


def _bits_equal(a, b):
    """Equal bit for bit, NaNs included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("epilogue", list(INT8_EPILOGUES))
@pytest.mark.parametrize("geometry", list(INT8_GEOMETRIES))
def test_int8_dequant_epilogue_equals_the_unfused_route(gen, geometry, epilogue, static,
                                                        monkeypatch):
    """int8_dequant's BN epilogue through models/resnet.py:conv_bn against
    the route without it (conv_bn finding no epilogue: the unfused
    int8_dequant, then NormInPromotedDtype, + residual and torch.relu as
    PyTorch ops), bit for bit, NaNs' bits too: every geometry (O a
    multiple of 8 and not; a subpixel conv's BN on each phase, the
    reindexed kernel's tiled), both scale routes, a residual in
    channels-last or NCHW memory (none reaches a subpixel conv), with and
    without the ReLU.  Sample 0 is zero; the BN's parameters and the
    residual hold NaN, +-inf and -0.  One int8_dequant a product, each
    with the epilogue."""
    from cspn_tpu_torch.models import resnet

    c, o, k, stride, pad, sub, n, h, w = INT8_GEOMETRIES[geometry]
    layout, relu = INT8_EPILOGUES[epilogue]
    if sub and layout:
        pytest.skip("no residual reaches a subpixel conv")
    qc = _int8_conv(gen, c, o, k, stride, pad, sub, static)
    bn = _serving_bn(gen, o)
    x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
    x[0] = 0
    x = x.contiguous(memory_format=torch.channels_last)
    args = (2 * h - 1, 2 * w) if sub else ()
    residual = None
    if layout:
        ho, wo = qc(x).shape[2:]
        residual = torch.randn(n, o, ho, wo, device="cuda", generator=gen).to(torch.bfloat16)
        residual.view(-1)[:4] = torch.tensor([-0.0, float("inf"), float("-inf"), float("nan")])
        residual[0] = -0.0
        if layout == "nhwc":
            residual = residual.contiguous(memory_format=torch.channels_last)
    products = len(qc._convs(qc.weight))
    with torch.no_grad():
        before = _int8_launches()
        got = resnet.conv_bn(qc, bn, x, *args, residual=residual, relu=relu)
        after = _int8_launches()
        monkeypatch.setattr(resnet, "bn_epilogue", lambda conv, bn, x: None)
        want = resnet.conv_bn(qc, bn, x, *args, residual=residual, relu=relu)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(after, before)] == [int(not static), products, products,
                                                      products]
    assert got.is_contiguous(memory_format=torch.channels_last) or sub
    assert _bits_equal(got, want)
    assert got.isnan().any() and (relu or (got.view(torch.int16) == -32768).any())  # NaN, -0


def test_int8_dequant_relu_keeps_torch_relus_zero_and_nan(gen):
    """The epilogue's ReLU at -0, +0, NaN, +-inf and finite values (a zero
    product after a BN of mean 0, mul -1, bias -0 gives -0, and the
    residual adds the value) against the same ops in PyTorch on the card,
    torch.relu's own -0 and NaN included: the same bits."""
    acc = torch.zeros(24, 8, dtype=torch.int32, device="cuda")
    scale = torch.ones(1, dtype=torch.bfloat16, device="cuda")
    ones = torch.ones(8, dtype=torch.bfloat16, device="cuda")
    mean, mul, bias = ones * 0, -ones, ones * -0.0
    vals = torch.tensor([-0.0, 0.0, float("nan"), float("inf"), float("-inf"), -1.0, 2.0, -0.0],
                        device="cuda").to(torch.bfloat16)
    r = vals.repeat(24).view(1, 4, 6, 8).permute(0, 3, 1, 2)
    got = torch.ops.cspn_tpu_torch.int8_dequant(acc, scale, ones, 1, 4, 6, torch.bfloat16, mean,
                                                mul, bias, residual=r, relu=True)

    def per_channel(t):
        return t.view(1, -1, 1, 1)

    y = torch.zeros_like(r)
    want = torch.relu((y - per_channel(mean)) * per_channel(mul) + per_channel(bias) + r)
    torch.cuda.synchronize()
    assert _bits_equal(got.permute(0, 3, 1, 2), want)


@pytest.mark.parametrize("epilogue", list(INT8_EPILOGUES))
def test_int8_dequant_epilogue_opcheck(gen, epilogue):
    """torch.library.opcheck on the card with the epilogue's arguments:
    schema, fake implementation and the CUDA implementation agree."""
    layout, relu = INT8_EPILOGUES[epilogue]
    x = torch.randn(2, 16, 5, 7, device="cuda", generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    scale = torch.ops.cspn_tpu_torch.act_absmax(x)
    a = torch.ops.cspn_tpu_torch.int8_taps(x, scale, 3, 3, 1, 1, 1, 1, 1, 144)
    w = torch.randint(-127, 128, (24, 144), dtype=torch.int8, device="cuda", generator=gen)
    acc = torch._int_mm(a, w.t())
    ws = torch.rand(24, device="cuda", generator=gen).to(torch.bfloat16)
    bn = [torch.randn(24, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3)]
    r = None
    if layout:
        r = torch.randn(2, 24, 5, 7, device="cuda", generator=gen).to(torch.bfloat16)
        if layout == "nhwc":
            r = r.contiguous(memory_format=torch.channels_last)
    torch.library.opcheck(torch.ops.cspn_tpu_torch.int8_dequant,
                          (acc, scale, ws, 2, 5, 7, torch.bfloat16, *bn, r, relu))


def _serving_int8_model(preset: str, gen):
    """The preset's int8 CSPN-UNet on the card as served: bf16 weights,
    seeded BN statistics (no special values), the weight cache."""
    import dataclasses

    from cspn_tpu_torch import config
    from cspn_tpu_torch.models.resnet import BatchNorm2d
    from cspn_tpu_torch.train import evaluate
    from cspn_tpu_torch.utils import quant
    from cspn_tpu_torch.utils.precision import cast_floating

    cfg = config.PRESETS[preset]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="int8"))
    model = evaluate.build_model(cfg, device="cuda")
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.load_state_dict(_serving_bn(gen, m.num_features, special=False).float().state_dict())
    model.load_state_dict(cast_floating(model.state_dict()), assign=True)
    quant.build_weight_qcache(model)
    return model


@pytest.mark.parametrize("preset, batch", [("nyu_eval", 8), ("nyu_eval", 32), ("nyu_eval", 128),
                                           ("kitti_benchmark", 4)],
                         ids=["nyu_b8", "nyu_b32", "nyu_b128", "kitti_b4"])
def test_int8_model_with_the_epilogue_equals_the_unfused_route(gen, preset, batch, monkeypatch):
    """The whole int8 CSPN-UNet, nyu_eval's ResNet-50 at 228x304 at the
    served int8 buckets and the offline batch, kitti_benchmark's ResNet-18
    at 352x1216: with the BN epilogue (82 and 43 of the dequantizations a
    forward) equal to the same model whose blocks run the BNs, adds and
    ReLUs as ops (conv_bn finding no epilogue), bit for bit."""
    from cspn_tpu_torch.models import resnet
    from cspn_tpu_torch.utils import quant

    model = _serving_int8_model(preset, gen)
    h, w = {"nyu_eval": (228, 304), "kitti_benchmark": (352, 1216)}[preset]
    launches = quant.kernel_launches(model)
    assert launches["int8_dequant_bn"] == launches["int8_dequant"] == {
        "nyu_eval": 82, "kitti_benchmark": 43}[preset]
    x = torch.randn(batch, h, w, 4, device="cuda", generator=gen)
    with torch.no_grad():
        before = _int8_launches()
        got = model(x)
        after = _int8_launches()
        monkeypatch.setattr(resnet, "bn_epilogue", lambda conv, bn, x: None)
        want = model(x)
        unfused = _int8_launches()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(after, before)] == list(launches.values())
    assert unfused[3] == after[3] and unfused[2] - after[2] == launches["int8_dequant"]
    assert torch.equal(got, want)


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    """float32 and int32 activations, one in NCHW memory, a CPU scale with a
    CUDA activation, a float32 product: each raises, and a float32
    QuantConv input too (a CUDA tensor never reaches the PyTorch glue)."""
    from cspn_tpu_torch.utils import quant

    x = torch.randn(2, 16, 5, 7, device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(ValueError, match="channels-last"):
        torch.ops.cspn_tpu_torch.act_absmax(x)
    x = x.contiguous(memory_format=torch.channels_last)
    scale = torch.ops.cspn_tpu_torch.act_absmax(x)
    with pytest.raises(TypeError, match="bf16"):
        torch.ops.cspn_tpu_torch.act_absmax(x.float())
    with pytest.raises(TypeError, match="bf16"):
        torch.ops.cspn_tpu_torch.int8_taps(x.int(), scale, 3, 3, 1, 1, 1, 1, 1, 144)
    with pytest.raises(ValueError, match="the scale is on cpu"):
        torch.ops.cspn_tpu_torch.int8_taps(x, scale.cpu(), 3, 3, 1, 1, 1, 1, 1, 144)
    acc = torch.zeros(70, 24, dtype=torch.int32, device="cuda")
    ws = torch.ones(24, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        torch.ops.cspn_tpu_torch.int8_dequant(acc.float(), scale, ws, 2, 5, 7, torch.bfloat16)
    qc = _int8_conv(gen, 16, 24, 3, 1, 1, False, False)
    with pytest.raises(TypeError, match="bf16"), torch.no_grad():
        qc(x.float())


@pytest.mark.parametrize("op", ["act_absmax", "int8_taps", "int8_dequant"])
def test_int8_ops_opcheck(gen, op):
    """torch.library.opcheck on the card: schema, fake implementation and
    the CUDA implementation agree."""
    x = torch.randn(2, 16, 5, 7, device="cuda", generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    scale = torch.ops.cspn_tpu_torch.act_absmax(x)
    a = torch.ops.cspn_tpu_torch.int8_taps(x, scale, 3, 3, 1, 1, 1, 1, 1, 144)
    w = torch.randint(-127, 128, (24, 144), dtype=torch.int8, device="cuda", generator=gen)
    acc = torch._int_mm(a, w.t())
    ws = torch.rand(24, device="cuda", generator=gen).to(torch.bfloat16)
    args = {"act_absmax": (x,), "int8_taps": (x, scale, 3, 3, 1, 1, 1, 1, 1, 144),
            "int8_dequant": (acc, scale, ws, 2, 5, 7, torch.bfloat16)}[op]
    torch.library.opcheck(getattr(torch.ops.cspn_tpu_torch, op), args)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_conv_exports_with_a_symbolic_batch(gen, static, tmp_path):
    """One QuantConv exported on the card with a symbolic batch, saved and
    loaded, serves batches of 1 (a map below 17 rows) and 3 as the eager
    PyTorch route does, bit for bit, launching one of each kernel a call
    (no act_absmax on a static scale)."""
    from cspn_tpu_torch import export
    from cspn_tpu_torch.utils import quant

    qc = _int8_conv(gen, 16, 24, 3, 2, 1, False, static)

    def batch(n):
        x = torch.randn(n, 16, 5, 7, device="cuda", generator=gen).to(torch.bfloat16)
        return x.contiguous(memory_format=torch.channels_last)

    dims = ({0: torch.export.Dim("b", min=1, max=64)},)
    with torch.no_grad():
        program = torch.export.export(qc, (batch(2),), dynamic_shapes=dims)
    want_ops = {"int8_taps": 1, "int8_dequant": 1, **({} if static else {"act_absmax": 1})}
    assert export.op_counts(program) == want_ops
    torch.export.save(program, tmp_path / "conv.pt2")
    loaded = torch.export.load(tmp_path / "conv.pt2").module()
    convs = list(zip(qc.quantized_weights(), [((1, 1), (1, 1))]))
    for n in (1, 3):
        x = batch(n)
        with torch.no_grad():
            before = _int8_launches()
            got = loaded(x)
            after = _int8_launches()
            want = qc._products_plain(x, qc._static_scale(x), convs)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert [a - b for a, b in zip(after, before)] == [int(not static), 1, 1, 0]


@pytest.mark.parametrize("case", ["stereo", "stereo zero-gates corner", "sharded segment"])
def test_cspn3d_kernels_at_the_paths_cases(gen, case):
    """chip_smoke.py's cspn3d_cases(): the stereo b4 volume with and without
    all-zero gates in a corner, and the sharded stereo segment at the cost
    model's K; the forward's kept states too."""
    from cspn_tpu_torch.parallel import halo

    m, d, h, w = 4, 48, 64, 128
    steps = 24
    if case == "sharded segment":
        steps = halo.effective_halo(None, 24, d // 2, h * w, m, n_gate_planes=26,
                                    t_step=halo.T3D_STEP_S_PER_VOX)
        m, d = 2 * m, d // 2 + 2 * steps
    shape = (m, d, h, w)
    g = torch.randn(m, 26, d, h, w, device="cuda", generator=gen)
    if case == "stereo zero-gates corner":
        g[0, :, :4, :6, :8] = 0.0
    gates = g.abs() / g.abs().sum(1, keepdim=True).clamp_min(1e-12)
    x0 = torch.randn(shape, device="cuda", generator=gen)
    ct = torch.randn(shape, device="cuda", generator=gen)
    out, states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)
    got_grads = cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps)
    torch.cuda.synchronize()
    want, want_grads = _plain_grads3d(gates, x0, ct, steps)
    want_states = [x0]
    for _ in range(steps - 1):
        want_states.append(cspn_ref.propagate_nd_reference(gates, want_states[-1], 1))
    for a, b in ((out, want), (states, torch.stack(want_states[1:])), *zip(got_grads, want_grads)):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL * b.abs().max().item()


# past one brick a block: the stereo model's volume at 1080x1920 and
# max_disp 192 (6.2 M voxels, every gate read from L2), a wider one whose
# columns exceed what a block's shared memory holds (168 bricks on 132
# blocks), and one deeper than 4 x SMs (150 slabs)
@pytest.mark.parametrize("shape, steps", [((1, 48, 270, 480), 3), ((1, 48, 400, 480), 2),
                                          ((2, 600, 8, 16), 5)])
def test_cspn3d_kernels_on_large_volumes(gen, shape, steps):
    gates = _gates3d(gen, *shape, zero_corner=True)
    x0 = torch.randn(shape, device="cuda", generator=gen)
    ct = torch.randn(shape, device="cuda", generator=gen)
    out, states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)
    unkept, _ = cspn3d_cuda._launch(gates, x0, steps)
    got_grads = cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps)
    torch.cuda.synchronize()
    assert torch.equal(out, unkept)
    want, want_grads = _plain_grads3d(gates, x0, ct, steps)
    for a, b in ((out, want), *zip(got_grads, want_grads)):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL * b.abs().max().item()


def test_cspn3d_forward_without_states_matches_kept(gen):
    """A forward that keeps no states runs them through two buffers in turn;
    its output is the kept forward's, bit for bit."""
    gates = _gates3d(gen, 4, 48, 64, 128)
    x0 = torch.randn(4, 48, 64, 128, device="cuda", generator=gen)
    for steps in (2, 3, 24):
        kept, states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)
        out, none = cspn3d_cuda._launch(gates, x0, steps)
        torch.cuda.synchronize()
        assert none is None and states.shape[0] == steps - 1 and torch.equal(out, kept)


@pytest.mark.parametrize("steps", [0, 1, 24])
def test_cspn3d_cuda_launches_per_call(gen, steps):
    """One CUDA launch a forward, two a backward (the reverse sweep and the
    gate-cotangent pass), counted by the host's launch records
    (_host_launches)."""
    gates = _gates3d(gen, 2, 12, 16, 32)
    x0 = torch.randn(2, 12, 16, 32, device="cuda", generator=gen)
    ct = torch.randn(2, 12, 16, 32, device="cuda", generator=gen)
    states = cspn3d_cuda._launch(gates, x0, steps, keep_states=True)[1]
    torch.cuda.synchronize()
    counts = tuple(_host_launches(fn) for fn in (
        lambda: cspn3d_cuda._launch(gates, x0, steps),
        lambda: cspn3d_cuda._launch_bwd(gates, x0, states, ct, steps)))
    assert counts == cspn3d_cuda.cuda_launches_per_call(steps)


def test_cspn3d_backward_on_the_same_states_is_bit_identical(gen):
    """Gather form, no atomics: two backwards on the forward's kept states
    agree bit for bit."""
    gates = _gates3d(gen, 4, 48, 64, 128)
    x0 = torch.randn(4, 48, 64, 128, device="cuda", generator=gen)
    ct = torch.randn(4, 48, 64, 128, device="cuda", generator=gen)
    states = cspn3d_cuda._launch(gates, x0, 24, keep_states=True)[1]
    first = cspn3d_cuda._launch_bwd(gates, x0, states, ct, 24)
    second = cspn3d_cuda._launch_bwd(gates, x0, states, ct, 24)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("channels", [1, 2])
def test_cspn_nd_3d_runs_the_kernels(gen, channels):
    """cspn_nd on CUDA (3D, kernel 3) goes through both kernels, channels
    last and first, and agrees with the reference backend on the card at
    the same gate dtype: float32, and bf16 (the kernels' default; the
    reference then rounds its gates as they do)."""
    guide = torch.randn(2, 5, 13, 17, 26 * channels, device="cuda", generator=gen)
    guide[0, :2, :3, :4] = 0.0
    feat = torch.randn(2, 5, 13, 17, channels, device="cuda", generator=gen)
    ct = torch.randn(feat.shape, device="cuda", generator=gen)
    for gate_dtype in (torch.float32, torch.bfloat16):
        outs = {}
        for backend in ("kernel", "reference"):
            g, f = guide.clone().requires_grad_(True), feat.clone().requires_grad_(True)
            before = (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches)
            out = cspn_nd(g, f, steps=24, backend=backend, gate_dtype=gate_dtype)
            outs[backend] = (out, *torch.autograd.grad(out, (g, f), ct))
            torch.cuda.synchronize()
            n = 1 if backend == "kernel" else 0
            assert (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches) == (before[0] + n, before[1] + n)
        for a, b in zip(outs["kernel"], outs["reference"]):
            assert (a - b).abs().max().item() <= TOL * b.abs().max().item()
        cf = cspn_nd(guide.movedim(-1, 1), feat.movedim(-1, 1), steps=24, channel_first=True,
                     gate_dtype=gate_dtype)
        ref = outs["reference"][0]
        assert (cf.movedim(1, -1) - ref).abs().max().item() <= TOL * ref.abs().max().item()


def test_cspn3d_wrapper_refuses_what_the_kernel_does_not_take(gen):
    gates = _gates3d(gen, 2, 3, 5, 7)
    x0 = torch.randn(2, 3, 5, 7, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        cspn3d_cuda.propagate3d(gates.double(), x0.double())
    with pytest.raises(ValueError, match="contiguous"):
        cspn3d_cuda.propagate3d(gates, x0.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match=r"\[M,26,D,H,W\]"):
        cspn3d_cuda.propagate3d(gates[:, :25].contiguous(), x0)
    with pytest.raises(ValueError, match=r"must be \[2,3,5,7\]"):
        cspn3d_cuda.propagate3d(gates, x0[:, :2].contiguous())
    with pytest.raises(NotImplementedError, match="kernel_size 5"):
        cspn_nd(torch.randn(1, 5, 7, 24, device="cuda"), torch.randn(1, 5, 7, 1, device="cuda"),
                kernel_size=5, backend="kernel")


def test_stereo_model_on_the_card_uses_the_kernels(gen):
    """A small PSMNetCSPN forward and train step through the 3D kernels
    launch each once and agree with the plain CSPN rounding its gates to
    bf16 as the kernels read them."""
    from cspn_tpu_torch.models.stereo import PSMNetCSPN, smooth_l1_disparity_loss

    torch.backends.cudnn.allow_tf32 = False
    with torch.device("cuda"):
        model = PSMNetCSPN(max_disp=16, features=8, cspn_steps=4,
                           generator=torch.Generator("cuda").manual_seed(0))
    model.cspn_gate_dtype = torch.bfloat16  # the kernels' default, on both routes
    left = torch.randn(2, 32, 48, 3, device="cuda", generator=gen)
    right = torch.randn(2, 32, 48, 3, device="cuda", generator=gen)
    disp = 1.0 + 14.0 * torch.rand(2, 32, 48, device="cuda", generator=gen)
    outs = {}
    for backend in ("auto", "reference"):
        model.cspn_backend = backend
        model.zero_grad(set_to_none=True)
        before = (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches)
        out = model(left, right)
        smooth_l1_disparity_loss(out, disp, 16).backward()
        torch.cuda.synchronize()
        n = 1 if backend == "auto" else 0
        assert (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches) == (before[0] + n, before[1] + n)
        outs[backend] = (out.detach(), model.guidance3d_head.weight.grad.clone())
    # the output within the kernels' 1e-4; the head's gradient sums float32
    # products over the whole volume in another order (cuDNN wgrad): 1e-3
    for a, b, tol in zip(outs["auto"], outs["reference"], (TOL, 1e-3)):
        assert (a - b).abs().max().item() <= tol * b.abs().max().item()


# --- the depth-to-space kernels (csrc/d2s.cu) -----------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("shape, crop", [
    ((8, 1024, 29, 38), (57, 76)),  # the b8 decoder's layer3, odd crop in both axes
    ((8, 36, 114, 152), (228, 304)),  # the fused head, no crop
    ((3, 4, 5, 7), (9, 13)),  # C=1
    ((2, 36, 6, 7), (12, 13)),
])
def test_d2s_kernels_match_plain_bit_for_bit(gen, shape, crop, dtype):
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    ct = torch.randn(shape[0], shape[1] // 4, *crop, device="cuda", generator=gen).to(dtype)
    before = (d2s.launches, d2s.bwd_launches)
    xk = x.clone().requires_grad_(True)
    got = d2s.depth_to_space2(xk, *crop)
    (gk,) = torch.autograd.grad(got, xk, ct)
    torch.cuda.synchronize()
    assert (d2s.launches, d2s.bwd_launches) == (before[0] + 1, before[1] + 1)
    xr = x.clone().requires_grad_(True)
    want = d2s.depth_to_space2_ref(xr, *crop)
    (gr,) = torch.autograd.grad(want, xr, ct)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want) and torch.equal(gk, gr)
    assert torch.equal(gk, d2s.space_to_depth2_ref(ct, *shape[2:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("shape, crop", [
    ((1, 1, 10, 19), (19, 38)),  # w = 19, C = 1: rows and planes not 16-byte aligned
    ((3, 1, 19, 19), (37, 37)),  # N = 3, odd crop in both axes
    ((3, 5, 15, 38), (29, 76)),  # w = 38
    ((1, 7, 29, 38), (57, 75)),
    ((2, 3, 6, 7), (9, 10)),  # a crop of several rows and columns
    ((8, 64, 15, 19), (29, 38)),  # layer2's rows, narrower
])
def test_d2s_phase_list_matches_plain_bit_for_bit(gen, shape, crop, dtype):
    """The four phases [N, C, h, w] as the decoder hands them: the output
    and the four phase gradients against the plain version (which joins
    them), one launch each way, each gradient its own contiguous tensor."""
    phases = [torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4)]
    ct = torch.randn(shape[0], shape[1], *crop, device="cuda", generator=gen).to(dtype)
    before = (d2s.launches, d2s.bwd_launches)
    pk = [p.clone().requires_grad_(True) for p in phases]
    got = d2s.depth_to_space2(pk, *crop)
    grads = torch.autograd.grad(got, pk, ct)
    torch.cuda.synchronize()
    assert (d2s.launches, d2s.bwd_launches) == (before[0] + 1, before[1] + 1)
    pr = [p.clone().requires_grad_(True) for p in phases]
    want = d2s.depth_to_space2_ref(pr, *crop)
    wants = torch.autograd.grad(want, pr, ct)
    assert got.dtype == dtype and got.is_contiguous() and torch.equal(got, want)
    for g, w in zip(grads, wants):
        assert g.shape == shape and g.is_contiguous() and torch.equal(g, w)
    # the joined tensor through the same kernels
    assert torch.equal(d2s.depth_to_space2(torch.cat(phases, 1), *crop), got)
    # phases that are views of one tensor, at offsets that are not 16-byte aligned
    joined = torch.cat(phases, 1)
    views = list(joined.chunk(4, 1))
    assert torch.equal(d2s._launch([v.contiguous() for v in views], *crop), got)
    assert torch.equal(torch.cat(d2s._launch_bwd(ct, *shape[2:], phases=True), 1),
                       d2s._launch_bwd(ct, *shape[2:]))


def test_d2s_on_cuda_never_reaches_the_plain_version(gen, monkeypatch):
    """A CUDA tensor goes to the kernels, forward and backward; the subpixel
    resnet18 model launches nine of each per train step."""
    from cspn_tpu_torch.models import unet

    def plain(*_args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(d2s, "depth_to_space2_ref", plain)
    monkeypatch.setattr(d2s, "space_to_depth2_ref", plain)
    x = torch.randn(2, 36, 6, 7, device="cuda", generator=gen, requires_grad=True)
    before = (d2s.launches, d2s.bwd_launches)
    out = d2s.depth_to_space2(x, 11, 13)
    out.backward(torch.randn(out.shape, device="cuda", generator=gen))
    torch.cuda.synchronize()
    assert (d2s.launches, d2s.bwd_launches) == (before[0] + 1, before[1] + 1)
    monkeypatch.setattr(torch, "cat", plain)  # nothing joins the phases either
    phases = [torch.randn(2, 9, 6, 7, device="cuda", generator=gen, requires_grad=True)
              for _ in range(4)]
    out = d2s.depth_to_space2(phases, 11, 13)
    out.backward(torch.randn(out.shape, device="cuda", generator=gen))
    torch.cuda.synchronize()
    assert (d2s.launches, d2s.bwd_launches) == (before[0] + 2, before[1] + 2)
    assert all(p.grad is not None and p.grad.shape == (2, 9, 6, 7) for p in phases)
    monkeypatch.undo()
    monkeypatch.setattr(d2s, "depth_to_space2_ref", plain)
    monkeypatch.setattr(d2s, "space_to_depth2_ref", plain)

    model = unet.cspn_unet_resnet18(cspn_steps=2, generator=torch.Generator().manual_seed(0))
    model = model.cuda().train()
    before = (d2s.launches, d2s.bwd_launches)
    model(torch.randn(2, 64, 96, 4, device="cuda", generator=gen)).square().mean().backward()
    torch.cuda.synchronize()
    assert (d2s.launches, d2s.bwd_launches) == (before[0] + 9, before[1] + 9)


def test_d2s_failed_build_raises(gen, monkeypatch, tmp_path):
    """A build that fails raises: nothing falls back to the plain version."""
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("--no-such-flag",))
    x = torch.randn(1, 8, 3, 4, device="cuda", generator=gen)
    before = d2s.launches
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        d2s.depth_to_space2(x, 6, 8)
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        d2s.depth_to_space2(list(x.chunk(4, 1)), 6, 8)
    assert d2s.launches == before


def test_d2s_wrapper_refuses_what_the_kernel_does_not_take(gen):
    with pytest.raises(TypeError, match="bytes"):
        d2s.depth_to_space2(torch.zeros(1, 8, 3, 4, dtype=torch.uint8, device="cuda"), 6, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        d2s.depth_to_space2(torch.zeros(1, 6, 3, 4, device="cuda"), 6, 8)
    with pytest.raises(TypeError, match="bytes"):
        d2s.depth_to_space2([torch.zeros(1, 2, 3, 4, dtype=torch.uint8, device="cuda")] * 4, 6, 8)
    # a tile of one row past a block's 227 KB of shared memory: the launch is refused
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        d2s.depth_to_space2([torch.zeros(1, 1, 1, 8000, dtype=torch.float64, device="cuda")] * 4,
                            2, 16000)


# --- the tiled 2D forward (csrc/cspn2d_tiled.cu) --------------------------


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 7, 8, 9, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 75, 101), (3, 33, 65), (1, 352, 1216)])
def test_tiled_kernel_matches_plain_and_the_per_step_kernel(gen, shape, steps, with_sparse,
                                                            norm_type):
    g, b, s = _inputs(gen, *shape, with_sparse)
    g[0, :, :5, :5] = 0.0
    before = (cspn_cuda.tiled_launches, cspn_cuda.launches)
    got = cspn_cuda._launch_tiled(g, b, s, steps, norm_type)
    per_step = cspn_cuda._launch(g, b, s, steps, norm_type)[0]
    torch.cuda.synchronize()
    assert (cspn_cuda.tiled_launches, cspn_cuda.launches) == (before[0] + 1, before[1] + 1)
    want = _plain(g, b, s, steps, norm_type)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
    assert torch.equal(got, per_step)  # the same march: the same FMA chains in the same order


def test_forward_routes_by_whether_a_backward_follows(gen):
    """A forward that no backward follows runs the tiled kernel; one under
    autograd runs cspn2d_fwd, and the backward runs cspn2d_bwd on the
    states it kept."""
    g, b, s = _inputs(gen, 2, 40, 56)
    ct = torch.randn(2, 40, 56, device="cuda", generator=gen)
    want = _grads(lambda g, b, s: _plain(g, b, s, 24, "8sum"), g, b, s, ct)

    def counts():
        return cspn_cuda.tiled_launches, cspn_cuda.launches, cspn_cuda.bwd_launches

    before = counts()
    with torch.no_grad():
        inference = cspn2d(g.movedim(1, -1), b, s, steps=24)
    assert counts() == (before[0] + 1, before[1], before[2])
    got = _grads(lambda g, b, s: cspn2d(g.movedim(1, -1), b, s, steps=24), g, b, s, ct)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.equal(inference, cspn_cuda._launch(g, b, s, 24, "8sum")[0])
    for a, x in zip(got, want):
        assert (a - x).abs().max().item() <= TOL * x.abs().max().item()


@pytest.mark.parametrize("steps", [0, 1, 2, 24])
def test_backward_on_the_kept_states_equals_the_replay(gen, steps):
    g, b, s = _inputs(gen, 2, 13, 17)
    ct = torch.randn(2, 13, 17, device="cuda", generator=gen)
    out, gates, states = cspn_cuda._launch(g, b, s, steps, "8sum")
    assert states.shape == (max(steps - 1, 0), 2, 13, 17)
    assert torch.equal(out, cspn_cuda._launch(g, b, s, steps, "8sum")[0])
    kept = cspn_cuda._launch_bwd(g, b, s, ct, steps, "8sum", (gates, states))
    replayed = cspn_cuda._launch_bwd(g, b, s, ct, steps, "8sum")
    assert all(torch.equal(a, r) for a, r in zip(kept, replayed))


def test_tiled_kernel_rounds_bf16_io(gen, monkeypatch):
    monkeypatch.setattr(cspn_cuda, "use_tiled", lambda *_: True)
    g, b, s = _inputs(gen, 2, 45, 70)
    before = cspn_cuda.tiled_launches
    got = cspn_cuda.cspn2d_cuda(g, b, s, steps=9, channel_first=True, io_dtype=torch.bfloat16)
    assert cspn_cuda.tiled_launches == before + 1
    want = _plain(*[t.to(torch.bfloat16).float() for t in (g, b, s)], 9, "8sum")
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


def test_tiled_failed_build_raises(gen, monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("--no-such-flag",))
    monkeypatch.setattr(cspn_cuda, "use_tiled", lambda *_: True)
    g, b, s = _inputs(gen, 1, 8, 9)
    before = cspn_cuda.tiled_launches
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        cspn_cuda.cspn2d_cuda(g, b, s, steps=4, channel_first=True)
    assert cspn_cuda.tiled_launches == before


# --- the tiled forward on bf16 inputs (csrc/cspn2d_tiled.cu:cspn2d_tiled_io) ---


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [0, 1, 12, 13, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13, 17), (2, 75, 101), (8, 228, 304)])
def test_tiled_kernel_reads_bf16_inputs(gen, shape, steps, with_sparse, norm_type):
    """bf16 inputs, and float32 inputs rounded in registers at io_dtype
    bfloat16, give the float32 kernel's values on `_round_io`'s inputs bit
    for bit; bf16 heads beside a float32 sparse map read it as it is (io
    None) or rounded (bfloat16)."""
    from cspn_tpu_torch.ops.cspn import _round_io

    bf = torch.bfloat16
    g, b, s = _inputs(gen, *shape, with_sparse)
    g[0, :, :5, :5] = 0.0
    s16 = None if s is None else s.to(bf)
    want = cspn_cuda._launch_tiled(*_round_io(g, b, s, bf), steps, norm_type)
    before = cspn_cuda.tiled_launches
    routes = [cspn_cuda._launch_tiled(g.to(bf), b.to(bf), s16, steps, norm_type),
              cspn_cuda._launch_tiled(g, b, s, steps, norm_type, bf),
              cspn_cuda._launch_tiled(g.to(bf), b.to(bf), s, steps, norm_type, bf)]
    heads = cspn_cuda._launch_tiled(g.to(bf), b.to(bf), s, steps, norm_type)
    torch.cuda.synchronize()
    assert cspn_cuda.tiled_launches == before + 4
    assert all(r.dtype == torch.float32 and torch.equal(r, want) for r in routes)
    g16, b16 = g.to(bf).float(), b.to(bf).float()
    assert torch.equal(heads, cspn_cuda._launch_tiled(g16, b16, s, steps, norm_type))
    plain = _plain(*_round_io(g, b, s, bf), steps, norm_type)
    assert (want - plain).abs().max().item() <= TOL * plain.abs().max().item()


def test_bf16_route_launches_only_the_kernel(gen):
    """cspn2d_cuda on bf16 heads at io_dtype bfloat16, no backward
    following: the tiled kernel's CUDA launches and nothing else (no cast,
    no copy), by torch.profiler's host records."""
    from torch.profiler import ProfilerActivity, profile

    bf = torch.bfloat16
    g, b, s = _inputs(gen, 2, 228, 304)
    g16, b16 = g.to(bf), b.to(bf)

    def call():
        with torch.no_grad():
            return cspn_cuda.cspn2d_cuda(g16, b16, s, channel_first=True, io_dtype=bf)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    host = sum(e.count for e in prof.key_averages()
               if e.key.startswith(("cudaLaunch", "cuLaunch")))
    kernels = {e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))}
    assert host == cspn_cuda.cuda_launches_per_call(24)["cspn2d_tiled"]
    assert all("cspn2d_tiled_kernel" in k for k in kernels), kernels


def test_bf16_train_routes_on_the_card(gen):
    """Under autograd: bf16 inputs without I/O rounding run cspn2d_fwd on
    their upcast and the backward on its kept states; at io_dtype bfloat16
    the tiled kernel and the replaying backward on the unrounded inputs.
    Both give the float32 route's values and gradients, in bf16."""
    bf = torch.bfloat16
    g, b, s = _inputs(gen, 2, 40, 56)
    ct = torch.randn(2, 40, 56, device="cuda", generator=gen)
    g16, b16 = g.to(bf), b.to(bf)

    def counts():
        return cspn_cuda.tiled_launches, cspn_cuda.launches, cspn_cuda.bwd_launches

    def run(io_dtype):
        gk, bk = g16.clone().requires_grad_(True), b16.clone().requires_grad_(True)
        out = cspn_cuda.cspn2d_cuda(gk, bk, s, channel_first=True, io_dtype=io_dtype)
        return (out, *torch.autograd.grad((out * ct).sum(), (gk, bk)))

    want = _grads(lambda g_, b_, s_: cspn_cuda.cspn2d_cuda(g_, b_, s_, channel_first=True),
                  g16.float(), b16.float(), s, ct)
    before = counts()
    kept = run(None)
    assert counts() == (before[0], before[1] + 1, before[2] + 1)
    replayed = run(bf)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
    for got in (kept, replayed):
        assert got[0].dtype == torch.float32 and got[1].dtype == got[2].dtype == bf
        assert all(torch.equal(a, x.to(bf)) for a, x in zip(got[1:], want))
    assert torch.equal(kept[0], cspn_cuda._launch(g16.float(), b16.float(), s, 24, "8sum")[0])
    assert torch.equal(replayed[0], cspn_cuda._launch_tiled(g16, b16, s, 24, "8sum", bf))


def test_bf16_route_refuses_what_the_kernel_does_not_take(gen):
    bf = torch.bfloat16
    g, b, s = _inputs(gen, 2, 13, 17)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cspn_cuda.cspn2d_cuda(g.half(), b.to(bf), s, channel_first=True)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            cspn_cuda.cspn2d_cuda(g.to(bf), b.to(bf), s.double(), channel_first=True)
        with pytest.raises(ValueError, match="on cpu"):
            cspn_cuda.cspn2d_cuda(g.to(bf), b.to(bf).cpu(), s, channel_first=True)
        with pytest.raises(ValueError, match="I/O dtype"):
            cspn_cuda.cspn2d_cuda(g, b, s, channel_first=True, io_dtype=torch.float16)


# --- the redesigned tile kernels at their edges (csrc/cspn2d_march.cuh) ---

# 1-row and 1-column maps, sides that are no multiple of the tile (40),
# several tiles each way
EDGE_SHAPES = [(2, 1, 300), (2, 300, 1), (1, 1, 1), (3, 97, 145), (1, 130, 99)]


@pytest.mark.parametrize("steps", [1, 7, 9, 24])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_tile_kernels_at_the_edges(gen, shape, steps):
    """The tiled forward equals cspn2d_fwd value for value and the plain
    version within TOL; the backward on the kept states equals the
    replay and a second run bit for bit, and autograd of the plain version
    within TOL."""
    for norm_type, with_sparse in (("8sum", True), ("8sum_abs", False)):
        g, b, s = _inputs(gen, *shape, with_sparse)
        g[0, :, :5, :5] = 0.0
        ct = torch.randn(shape, device="cuda", generator=gen)
        got = cspn_cuda._launch_tiled(g, b, s, steps, norm_type)
        out, gates, states = cspn_cuda._launch(g, b, s, steps, norm_type)
        kept = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm_type, (gates, states))
        again = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm_type, (gates, states))
        replayed = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm_type)
        torch.cuda.synchronize()
        assert torch.equal(got, out)
        want = _plain(g, b, s, steps, norm_type)
        assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
        assert all(torch.equal(a, x) for a, x in zip(kept, again))
        assert all(torch.equal(a, x) for a, x in zip(kept, replayed))
        plain = _grads(lambda g, b, s: _plain(g, b, s, steps, norm_type), g, b, s, ct)
        for a, x in zip(kept, plain):
            assert torch.isfinite(a).all()
            assert (a - x).abs().max().item() <= TOL * max(x.abs().max().item(), 1e-30)


@pytest.mark.parametrize("steps", [0, 1, 9, 24])
def test_tile_kernels_cuda_launches_per_call(gen, steps):
    """The CUDA launches of one call, counted by torch.profiler: each
    forward ceil(steps / K), the backward ceil(steps / K) + 1 on kept
    states, with max(1, ceil((steps - 1) / K)) replay launches before them
    without.  Counted by the host's launch records (_host_launches): the
    card's kernel records can lose a profile's first kernel."""
    g, b, s = _inputs(gen, 2, 60, 70)
    ct = torch.randn(2, 60, 70, device="cuda", generator=gen)
    _, gates, states = cspn_cuda._launch(g, b, s, steps, "8sum")
    torch.cuda.synchronize()
    calls = {"cspn2d_fwd": lambda: cspn_cuda._launch(g, b, s, steps, "8sum"),
             "cspn2d_tiled": lambda: cspn_cuda._launch_tiled(g, b, s, steps, "8sum"),
             "cspn2d_bwd_kept": lambda: cspn_cuda._launch_bwd(g, b, s, ct, steps, "8sum",
                                                              (gates, states)),
             "cspn2d_bwd_replay": lambda: cspn_cuda._launch_bwd(g, b, s, ct, steps, "8sum")}
    counts = {name: _host_launches(fn) for name, fn in calls.items()}
    assert counts == cspn_cuda.cuda_launches_per_call(steps)


def _plain_states(g, b, s, steps, norm_type):
    return [_plain(g, b, s, t, norm_type) for t in range(1, steps)]


@pytest.mark.parametrize("steps", [1, 11, 12, 13, 24, 25])
@pytest.mark.parametrize("shape", [(2, 1, 300), (2, 300, 1), (3, 97, 145), (1, 352, 1216)])
def test_states_forward_at_its_launch_edges(gen, shape, steps):
    """cspn2d_fwd at launch splits 1, 11, 12, 12 + 1, 12 + 12 and 12 + 12 +
    1 steps, on 1-row and 1-column maps and ragged tiles: every kept state
    within TOL of the plain forward's x_t, the output the tiled forward's
    value for value, the folded gates the ones the replay writes, and the
    backward on them its replay's bit for bit."""
    for norm_type, with_sparse in (("8sum", True), ("8sum_abs", False)):
        g, b, s = _inputs(gen, *shape, with_sparse)
        g[0, :, :5, :5] = 0.0
        ct = torch.randn(shape, device="cuda", generator=gen)
        before = cspn_cuda.launches
        out, gates, states = cspn_cuda._launch(g, b, s, steps, norm_type)
        tiled = cspn_cuda._launch_tiled(g, b, s, steps, norm_type)
        torch.cuda.synchronize()
        assert cspn_cuda.launches == before + 1
        assert states.shape == (steps - 1, *shape) and gates.shape == g.shape
        assert torch.equal(out, tiled)
        for t, want in enumerate(_plain_states(g, b, s, steps, norm_type), start=1):
            assert torch.isfinite(states[t - 1]).all()
            assert (states[t - 1] - want).abs().max().item() <= TOL * want.abs().max().item()
        kept = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm_type, (gates, states))
        replayed = cspn_cuda._launch_bwd(g, b, s, ct, steps, norm_type)
        assert all(torch.equal(a, x) for a, x in zip(kept, replayed))


# --- the paddle-semantics 2D CSPN (csrc/paddle2d.cu) ----------------------


def _paddle_inputs(gen, n, h, w, c, channel_first):
    guide = torch.randn(n, h, w, 8 * c, device="cuda", generator=gen)
    guide[0, :3, :4] = 0.0  # all-zero gates: centre weight 1
    feat = torch.randn(n, h, w, c, device="cuda", generator=gen)
    if channel_first:
        return guide.movedim(-1, 1).contiguous(), feat.movedim(-1, 1).contiguous()
    return guide, feat


@pytest.mark.parametrize("channel_first", [False, True])
@pytest.mark.parametrize("steps", [0, 1, 11, 12, 13, 24])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 64, 128, 1), (2, 13, 17, 2), (4, 228, 304, 2)])
def test_paddle2d_kernel_matches_plain(gen, shape, steps, channel_first):
    """The kernel from the raw guide in either of cspn_nd's layouts, at odd
    H and W, C = 2 and the march's launch splits, against its plain version;
    the gradients (autograd of the plain version at the saved inputs) too."""
    guide, feat = _paddle_inputs(gen, *shape, channel_first)
    ct = torch.randn(feat.shape, device="cuda", generator=gen)
    outs = {}
    for label, fn in (("kernel", cspn_paddle2d_cuda.cspn2d_paddle_cuda),
                      ("plain", cspn_paddle2d_cuda.paddle2d_reference)):
        g, f = guide.clone().requires_grad_(True), feat.clone().requires_grad_(True)
        before = cspn_paddle2d_cuda.launches
        out = fn(g, f, steps=steps, channel_first=channel_first)
        outs[label] = (out, *torch.autograd.grad(out, (g, f), ct, allow_unused=True))
        torch.cuda.synchronize()
        assert cspn_paddle2d_cuda.launches == before + (label == "kernel")
    for a, b in zip(outs["kernel"], outs["plain"]):
        if b is None:  # steps=0: the output is feat, the guide has no gradient
            assert steps == 0 and not a.any()
            continue
        assert a.shape == b.shape and a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL * max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("steps", [0, 1, 11, 12, 13, 24])
def test_paddle2d_cuda_launches(gen, steps):
    """ceil(steps / 12) CUDA launches a forward by the host's records (2 at
    24 steps), and cspn_nd's 2D forward launches nothing else."""
    guide, feat = _paddle_inputs(gen, 3, 64, 128, 1, False)
    want = cspn_paddle2d_cuda.cuda_launches(steps)
    assert want == (0 if steps == 0 else 1 if steps <= 12 else 2)
    assert _host_launches(lambda: cspn_paddle2d_cuda._launch(guide, feat, steps)) == want
    with torch.no_grad():
        assert _host_launches(lambda: cspn_nd(guide, feat, steps=steps)) == want


@pytest.mark.parametrize("channels", [1, 2])
def test_cspn_nd_2d_runs_the_paddle_kernel(gen, channels):
    guide = torch.randn(2, 13, 17, 8 * channels, device="cuda", generator=gen)
    guide[0, :2, :3] = 0.0
    feat = torch.randn(2, 13, 17, channels, device="cuda", generator=gen)
    ct = torch.randn(feat.shape, device="cuda", generator=gen)
    outs = {}
    for backend in ("kernel", "reference"):
        g, f = guide.clone().requires_grad_(True), feat.clone().requires_grad_(True)
        before = cspn_paddle2d_cuda.launches
        out = cspn_nd(g, f, steps=24, backend=backend)
        outs[backend] = (out, *torch.autograd.grad(out, (g, f), ct))
        torch.cuda.synchronize()
        assert cspn_paddle2d_cuda.launches == before + (backend == "kernel")
    for a, b in zip(outs["kernel"], outs["reference"]):
        assert (a - b).abs().max().item() <= TOL * b.abs().max().item()
    cf = cspn_nd(guide.movedim(-1, 1), feat.movedim(-1, 1), steps=24, channel_first=True)
    ref = outs["reference"][0]
    assert (cf.movedim(1, -1) - ref).abs().max().item() <= TOL * ref.abs().max().item()


def test_paddle2d_wrapper_refuses_what_the_kernel_does_not_take(gen):
    guide = torch.rand(2, 5, 7, 8, device="cuda", generator=gen)
    feat = torch.randn(2, 5, 7, 1, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        cspn_paddle2d_cuda.cspn2d_paddle_cuda(guide.double(), feat.double())
    with pytest.raises(ValueError, match="contiguous"):
        cspn_paddle2d_cuda.cspn2d_paddle_cuda(guide, feat.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="C\\*8"):
        cspn_paddle2d_cuda.cspn2d_paddle_cuda(guide[..., :7].contiguous(), feat)
    with pytest.raises(ValueError, match="C\\*8"):
        cspn_paddle2d_cuda.cspn2d_paddle_cuda(guide, feat[:, :4].contiguous())


# --- the step-body probe (csrc/step_probe.cu) -----------------------------


@pytest.mark.parametrize("gate_dtype, state_dtype", step_probe.PAIRS)
@pytest.mark.parametrize("iters", [0, 1, 4])
def test_step_probe_kernel_matches_plain(gen, gate_dtype, state_dtype, iters):
    g, x = step_probe.probe_inputs(3, gate_dtype, state_dtype, device="cuda", seed=iters)
    before = step_probe.launches
    got = step_probe.step_probe(g, x, iters)
    torch.cuda.synchronize()
    assert step_probe.launches == before + 1
    want = step_probe.step_probe_ref(g, x, iters)
    tol = 1e-2 if state_dtype == torch.bfloat16 else TOL
    assert got.dtype == state_dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()


def test_step_probe_measures_every_pair(gen):
    results = step_probe.run_probe(iters_lo=16, iters_hi=64, trials=2)
    assert [(r["gate_dtype"], r["state_dtype"]) for r in results] == [
        ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]
    assert all(r["blocks"] == torch.cuda.get_device_properties(0).multi_processor_count
               for r in results)


# --- the sharded CSPN's segment (csrc/cspn2d_halo_seg.cu, _bwd.cu) --------


def _segment(gen, n, he, w, with_keep):
    gates = torch.randn(n, 8, he, w, device="cuda", generator=gen) / 4
    base = torch.randn(n, he, w, device="cuda", generator=gen)
    keep = None
    if with_keep:
        mask = torch.sign(torch.randn(n, he, w, device="cuda", generator=gen))
        keep = 1.0 - torch.where(torch.rand(n, he, w, device="cuda", generator=gen) < 0.2, mask, 0.0)
    x = torch.randn(n, he, w, device="cuda", generator=gen)
    return gates, base, keep, x


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [0, 1, 8, 11])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 12, 20), (3, 41, 70), (2, 192, 1216)])
def test_halo_segment_kernels_match_plain(gen, shape, k_steps, with_keep):
    """Forward and every gradient of the segment against the plain version
    and its autograd under a random cotangent; K = 11 takes two tile
    launches."""
    from cspn_tpu_torch.ops import cspn_halo_cuda

    inputs = _segment(gen, *shape, with_keep)
    ct = torch.randn(shape, device="cuda", generator=gen)
    outs = {}
    for label, fn in (("kernel", cspn_halo_cuda.cspn2d_halo_segment),
                      ("plain", cspn_ref.halo_segment_reference)):
        ts = [None if t is None else t.clone().requires_grad_(True) for t in inputs]
        before = (cspn_halo_cuda.launches, cspn_halo_cuda.bwd_launches)
        out = fn(*ts, k_steps)
        leaves = [t for t in ts if t is not None]
        grads = torch.autograd.grad(out, leaves, ct, allow_unused=True)  # K = 0: out is x
        grads = [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads)]
        torch.cuda.synchronize()
        n = int(label == "kernel")
        assert (cspn_halo_cuda.launches, cspn_halo_cuda.bwd_launches) == (before[0] + n,
                                                                           before[1] + n)
        outs[label] = (out, *grads)
    for a, b in zip(outs["kernel"], outs["plain"]):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= TOL * max(b.abs().max().item(), 1e-30)


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [1, 11, 12, 13, 24])
@pytest.mark.parametrize("shape", [(2, 1, 70), (2, 53, 1), (3, 61, 90), (2, 120, 1216)])
def test_halo_segment_forward_routes_agree(gen, shape, k_steps, with_keep):
    """The segment's two forward routes (csrc/cspn2d_halo_seg.cu: storing
    only the output, or also the states and folded gates a backward reads)
    at K across their launch splits, on 1-row and 1-column blocks and
    ragged tiles: equal value for value, every kept state within TOL of
    the plain segment run t steps, the folded gates keep * gate exactly,
    and each route's kernel launches the host makes as many as
    cuda_launches gives."""
    from cspn_tpu_torch.ops import cspn_halo_cuda

    gates, base, keep, x = _segment(gen, *shape, with_keep)
    out = cspn_halo_cuda._launch(gates, base, keep, x, k_steps)
    kept_out, folded, states = cspn_halo_cuda._launch(gates, base, keep, x, k_steps,
                                                      keep_states=True)
    torch.cuda.synchronize()
    assert torch.equal(out, kept_out)
    assert torch.equal(folded, gates if keep is None else keep[:, None] * gates)
    assert states.shape == (k_steps - 1, *shape)
    xt = x
    for t in range(k_steps - 1):
        xt = cspn_ref.halo_segment_reference(gates, base, keep, xt, 1)
        assert (states[t] - xt).abs().max().item() <= TOL * max(xt.abs().max().item(), 1e-30)
    want = cspn_halo_cuda.cuda_launches(k_steps, with_keep)[0]
    for kw in ({}, {"keep_states": True}):
        fwd = lambda: cspn_halo_cuda._launch(gates, base, keep, x, k_steps, **kw)  # noqa: E731
        assert _host_launches(fwd) == want, kw


def _host_launches(fn, reps: int = 3) -> float:
    """The kernel launches the host makes in one call of `fn`
    (torch.profiler's cudaLaunch* records, which unlike the card's kernel
    records miss none; chip_smoke.py:kernel_profile)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("cudaLaunch")) / reps


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [1, 11, 12, 13, 24])
@pytest.mark.parametrize("shape", [(2, 1, 70), (2, 53, 1), (3, 61, 90), (2, 120, 1216)])
def test_halo_segment_backward_at_its_launch_edges(gen, shape, k_steps, with_keep):
    """The segment backward (reverse tiles of 12 steps on the states the
    forward kept, and the keep epilogue) at K across its launch splits,
    on 1-row and 1-column blocks and ragged tiles: every gradient within
    TOL of autograd of the plain segment, a second backward bit for bit
    the first, and the kernel launches the host makes as many as
    cuda_launches gives."""
    from cspn_tpu_torch.ops import cspn_halo_cuda

    gates, base, keep, x = _segment(gen, *shape, with_keep)
    ct = torch.randn(shape, device="cuda", generator=gen)
    kept = cspn_halo_cuda._launch(gates, base, keep, x, k_steps, keep_states=True)[1:]
    before = cspn_halo_cuda.bwd_launches
    got = cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k_steps, kept)
    again = cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k_steps, kept)
    torch.cuda.synchronize()
    assert cspn_halo_cuda.bwd_launches == before + 2
    assert all(torch.equal(a, e) for a, e in zip(got, again) if a is not None)
    leaves = [t.clone().requires_grad_(True) for t in (gates, base, keep, x) if t is not None]
    ts = leaves if with_keep else leaves[:2] + [None] + leaves[2:]
    want = torch.autograd.grad(cspn_ref.halo_segment_reference(*ts, k_steps), leaves, ct)
    got = [got[0], got[1]] + ([got[2]] if with_keep else []) + [got[3]]
    for a, e in zip(got, want):
        assert a.shape == e.shape and torch.isfinite(a).all()
        assert (a - e).abs().max().item() <= TOL * max(e.abs().max().item(), 1e-30)
    bwd = lambda: cspn_halo_cuda._launch_bwd(gates, keep, x, ct, k_steps, kept)  # noqa: E731
    assert _host_launches(bwd) == cspn_halo_cuda.cuda_launches(k_steps, with_keep)[1]


def test_halo_segment_wrapper_refuses_what_the_kernel_does_not_take(gen):
    from cspn_tpu_torch.ops import cspn_halo_cuda

    gates, base, keep, x = _segment(gen, 2, 12, 20, True)
    with pytest.raises(TypeError, match="float32"):
        cspn_halo_cuda.cspn2d_halo_segment(gates.double(), base, keep, x, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cspn_halo_cuda.cspn2d_halo_segment(gates, base, keep, x.transpose(1, 2).contiguous()
                                           .transpose(1, 2), 2)
    with pytest.raises(ValueError, match=r"\[n,8,He,W\]"):
        cspn_halo_cuda.cspn2d_halo_segment(gates[:, :7].contiguous(), base, keep, x, 2)
    with pytest.raises(ValueError, match=r"must be \[2,12,20\]"):
        cspn_halo_cuda.cspn2d_halo_segment(gates, base, keep[:, :11].contiguous(), x, 2)


@pytest.mark.parametrize("spatial", [2, 4])
def test_sharded_cspn_on_the_card_runs_the_segment_kernels(gen, spatial):
    """cspn2d_spatial on the in-process mesh: one forward and one backward
    kernel run per segment, and the result and gradients are the unsharded
    plain CSPN's within 1e-4 x max."""
    from cspn_tpu_torch.ops import cspn_halo_cuda
    from cspn_tpu_torch.parallel import cspn2d_spatial, halo, make_mesh

    g, b, s = _inputs(gen, 2, 64, 96)
    ct = torch.randn(2, 64, 96, device="cuda", generator=gen)
    steps, k = 24, 8
    want = _grads(lambda g, b, s: _plain(g, b, s, steps, "8sum"), g, b, s, ct)
    before = (cspn_halo_cuda.launches, cspn_halo_cuda.bwd_launches)
    got = _grads(lambda g, b, s: cspn2d_spatial(g, b, s, mesh=make_mesh(spatial=spatial),
                                                steps=steps, halo=k, channel_first=True), g, b, s, ct)
    torch.cuda.synchronize()
    assert (cspn_halo_cuda.launches - before[0], cspn_halo_cuda.bwd_launches - before[1]) == (3, 3)
    assert halo.effective_halo(k, steps, 64 // spatial, 96, 2) == k
    for a, x in zip(got, want):
        assert (a - x).abs().max().item() <= TOL * x.abs().max().item()


def test_sharded_models_on_the_card_use_the_kernels(gen):
    """A sharded resnet18 CSPN-UNet and PSMNetCSPN (S = 2) give the
    unsharded models' outputs on the card, through the segment kernels and
    the 3D kernels (the unsharded stereo model on float32 gates, the
    sharded segments')."""
    from cspn_tpu_torch.models import unet
    from cspn_tpu_torch.models.stereo import PSMNetCSPN
    from cspn_tpu_torch.ops import cspn_halo_cuda
    from cspn_tpu_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(spatial=2)
    x = torch.randn(2, 64, 96, 4, device="cuda", generator=gen)
    depth = [unet.cspn_unet_resnet18(cspn_steps=8, spatial_mesh=m, spatial_halo=4,
                                     generator=torch.Generator().manual_seed(0)).cuda().eval()
             for m in (None, mesh)]
    before = cspn_halo_cuda.launches
    with torch.inference_mode():
        want, got = (m(x) for m in depth)
    assert cspn_halo_cuda.launches == before + 2
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
    with torch.device("cuda"):
        stereo = [PSMNetCSPN(max_disp=32, features=8, cspn_steps=4, spatial_mesh=m,
                             generator=torch.Generator("cuda").manual_seed(0)).eval()
                  for m in (None, mesh)]
    stereo[0].cspn_gate_dtype = torch.float32
    left, right = (torch.randn(2, 32, 48, 3, device="cuda", generator=gen) for _ in range(2))
    before = cspn3d_cuda.launches
    with torch.inference_mode():
        want, got = (m(left, right) for m in stereo)
    assert cspn3d_cuda.launches > before + 1
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()


# --- the deployment path: the kernels as torch custom ops in an exported graph ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_export_on_the_card_launches_the_kernels(gen, dtype, tmp_path):
    """An artifact exported on the card (export.py) holds the tiled 2D CSPN
    op once and `d2s` nine times, serves a symbolic batch through the
    kernels, and equals the eager model bit for bit, at int8 too, where
    the excluded decoder block takes layer3's channels-last int8 output and
    cuDNN hands `d2s` a channels-last convolution output that the fake
    tensors at trace time had as contiguous."""
    import dataclasses

    from cspn_tpu_torch import config, export
    from cspn_tpu_torch.train.evaluate import load_eval_state

    cfg = config.PRESETS["synthetic_smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_steps=4, dtype=dtype),
                              best_model_dir=str(tmp_path))
    model = load_eval_state(cfg, device="cuda")
    program = export.export_serving(model, 64, 96)
    int8_ops = {}
    if dtype == "int8":  # the int8 conv's kernels (ops/quant_cuda.py)
        from cspn_tpu_torch.utils import quant

        int8_ops = {k: v for k, v in quant.kernel_launches(model).items() if v}
        assert int8_ops.pop("int8_dequant_bn") == int8_ops["int8_dequant"]  # in the same op
    assert export.op_counts(program) == {"cspn2d_tiled": 1, "d2s": 9, **int8_ops}
    export.save_artifact(program, str(tmp_path / "m.pt2"), {"arch": "resnet18", "dtype": dtype,
                                                           "cspn_steps": 4, "height": 64,
                                                           "width": 96, "batch": None})
    art = export.load_artifact(str(tmp_path / "m.pt2"))
    for n in (1, 3):
        x = torch.randn(n, 64, 96, 4, device="cuda", generator=gen)
        with torch.no_grad():
            want = model(x)
        before = (cspn_cuda.tiled_launches, d2s.launches, cspn_cuda.launches)
        got = art.call(x)
        torch.cuda.synchronize()
        assert (cspn_cuda.tiled_launches, d2s.launches, cspn_cuda.launches) == (
            before[0] + 1, before[1] + 9, before[2])
        assert torch.equal(got, want)


# --- the file datasets: nyu_train fed from PNG files ---


def test_nyu_train_from_png_files_launches_the_kernels(gen, tmp_path):
    """nyu_train (ResNet-50, 228x304, b8) fed from 480x640 PNG pairs (8-bit
    RGB, 16-bit depth in millimetres) through the host library: a fit of 2
    steps and 2 val frames launches the train route's kernels a step and the
    tiled forward a val frame, as the synthetic fit does."""
    import dataclasses

    import numpy as np

    from cspn_tpu_torch import config
    from cspn_tpu_torch.data import SyntheticDepthDataset
    from cspn_tpu_torch.train.factory import build_loaders
    from cspn_tpu_torch.train.loop import Trainer
    from cspn_tpu_torch.utils.images import write_png

    frames = SyntheticDepthDataset(length=18, hw=(480, 640), n_sample=1, seed=3,
                                   return_raw_rgb=True)
    lists = {}
    for split, idx in (("train", range(16)), ("val", range(16, 18))):
        rows = []
        for i in idx:
            f = frames[i]
            write_png(str(tmp_path / f"{i}_rgb.png"),
                      np.clip(f["raw_rgb"] * 255 + 0.5, 0, 255).astype(np.uint8))
            write_png(str(tmp_path / f"{i}_d.png"), np.round(f["depth"] * 1000).astype(np.uint16))
            rows.append(f"{i}_rgb.png,{i}_d.png")
        lists[split] = tmp_path / f"{split}.csv"
        lists[split].write_text("rgb,depth\n" + "\n".join(rows) + "\n")
    cfg = config.PRESETS["nyu_train"]
    cfg = dataclasses.replace(cfg, save_dir=str(tmp_path), best_model_dir=str(tmp_path),
                              data=dataclasses.replace(
                                  cfg.data, input_format="img", root_dir=str(tmp_path),
                                  train_list=str(lists["train"]), eval_list=str(lists["val"])))
    trainer = Trainer(cfg, *build_loaders(cfg), device="cuda")
    counters = lambda: (cspn_cuda.launches, cspn_cuda.bwd_launches, cspn_cuda.tiled_launches,  # noqa: E731
                        d2s.launches, d2s.bwd_launches)
    before = counters()
    val = trainer.fit(1)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(counters(), before))
    assert got == (2, 2, 2, 9 * 4, 9 * 2)
    assert all(np.isfinite(v) for v in val.values())


# --- serving: one CUDA graph a bucket ---


def test_graphed_server_equals_eager_and_counts_replays(gen):
    """DepthServer replays one captured graph a bucket: a request of 300
    frames at buckets (1, 8, 128) replays bucket 128's graph three times
    (128 + 128 + 44 padded), and every row equals the eager server's bit
    for bit (the first chunk's rows were cloned before the next replay
    overwrote the graph's output); the launch counters count each replay's
    tiled 2D CSPN and nine `d2s`, and no capture."""
    import numpy as np

    from cspn_tpu_torch.models import unet
    from cspn_tpu_torch.serving import DepthServer
    from cspn_tpu_torch.train.evaluate import calibrate_bn_stats

    with torch.device("cuda"):
        model = unet.cspn_unet_resnet18(cspn_steps=4, generator=gen)
    calibrate_bn_stats(model, torch.randn(8, 64, 96, 4, device="cuda", generator=gen))
    buckets = (1, 8, 128)
    graphed = DepthServer(model, buckets)
    eager = DepthServer(model, buckets, cuda_graphs=False)
    assert graphed.cuda_graphs and not eager.cuda_graphs
    graphed.warmup(64, 96)
    assert sorted(graphed.graphs) == [(b, 64, 96) for b in buckets]
    x = torch.randn(300, 64, 96, 4, device="cuda", generator=gen).cpu().numpy()
    want = eager.predict(x)
    before = (cspn_cuda.tiled_launches, d2s.launches, cspn_cuda.launches)
    got = graphed.predict(x)
    assert (cspn_cuda.tiled_launches, d2s.launches, cspn_cuda.launches) == (
        before[0] + 3, before[1] + 27, before[2])
    assert got.shape == (300, 64, 96) and np.isfinite(want).all() and (got == want).all()
    assert graphed.served == {"bf16": 300, "int8": 0}
    one = graphed.predict(x[:5])  # bucket 8, pad rows zeroed
    assert (one == eager.predict(x[:5])).all()
    model.load_state_dict(model.state_dict())
    assert graphed.graphs == {}
