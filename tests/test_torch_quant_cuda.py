"""The int8 convolution's kernels as torch ops (ops/quant_cuda.py), on the
CPU: what can be held here without a card.

  - the fake implementations give the CUDA kernels' shapes, dtypes and
    strides on fake CUDA tensors, for a concrete batch and a symbolic one
    (the rows of A as max(N * Ho * Wo, 17));
  - a one-QuantConv module on the card's route exports with a symbolic
    batch, one node an op, and keeps them through a save and load;
  - the launch counts a forward (64 / 82 / 82 in the nyu CSPN-UNet, all
    82 dequantizations with the BN epilogue on the serving weights);
    QuantConv on CPU tensors takes the PyTorch route and launches nothing,
    and the ops have no CPU implementation; the wrappers raise on what the
    kernels do not take;
  - `int8_dequant`'s BN epilogue (models/resnet.py:conv_bn): its fake for
    each flag combination, a QuantConv + BN + residual + ReLU block
    exported on the card's route, the blocks' CPU route (today's ops, one
    by one) and, with the epilogue handed to QuantConv on the CPU too,
    the PyTorch route's form of it, bit for bit.

The kernels themselves, against the PyTorch route on the card, and the
ops' opcheck are in tests/test_torch_cuda.py.
"""

import dataclasses

import pytest
import torch
from torch._dynamo.source import ConstantSource
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.symbolic_shapes import ShapeEnv

from cspn_tpu_torch import config, export, serving
from cspn_tpu_torch.models import decoder, resnet
from cspn_tpu_torch.ops import quant_cuda
from cspn_tpu_torch.train import evaluate
from cspn_tpu_torch.utils import quant
from cspn_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

# (C, O, kernel, stride, padding, subpixel, N, H, W): 1x1 at stride 1 and 2,
# 3x3 at stride 1 and 2, a 5x5, a map of fewer than 17 output pixels, C = 8
# and C = 24, and C = 5 (no vector); the card tests take the same
GEOMETRIES = {
    "1x1": (32, 24, 1, 1, 0, False, 2, 5, 7),
    "1x1_s2": (16, 40, 1, 2, 0, False, 2, 7, 9),
    "3x3": (16, 24, 3, 1, 1, False, 2, 5, 7),
    "3x3_s2": (32, 16, 3, 2, 1, False, 2, 7, 9),
    "subpixel_5x5": (16, 128, 5, 1, 2, True, 2, 5, 7),
    "few_rows": (16, 8, 3, 2, 1, False, 1, 4, 5),
    "c8": (8, 16, 3, 1, 1, False, 2, 5, 7),
    "c24": (24, 16, 3, 1, 1, False, 2, 5, 7),
    "c5": (5, 12, 3, 1, 1, False, 2, 5, 7),
}


def quant_conv(c, o, k, stride, pad, subpixel, static=False, seed=0):
    conv = torch.nn.Conv2d(c, o, k, stride=stride, padding=pad, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=torch.Generator().manual_seed(seed)))
    qc = quant.QuantConv(conv, subpixel=subpixel).to(torch.bfloat16)
    quant.build_weight_qcache(qc)
    if static:
        qc.act_max = torch.tensor(2.5)
    return qc


def activation(n, c, h, w, seed=1):
    x = torch.randn(n, c, h, w, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16)
    return x.contiguous(memory_format=torch.channels_last)


def _fake_outputs(n, geometry):
    """The three ops' fake outputs for a fake CUDA input of batch n."""
    c, o, k, stride, pad, _, _, h, w = GEOMETRIES[geometry]
    kp = -(-k * k * c // 8) * 8
    x = torch.empty(n, h, w, c, dtype=torch.bfloat16, device="cuda").permute(0, 3, 1, 2)
    s = torch.ops.cspn_tpu_torch.act_absmax(x)
    a = torch.ops.cspn_tpu_torch.int8_taps(x, s, k, k, stride, pad, pad, pad, pad, kp)
    acc = torch._int_mm(a, torch.empty(-(-o // 8) * 8, kp, dtype=torch.int8, device="cuda").t())
    ho, wo = quant_cuda.out_hw(h, w, k, k, stride, pad, pad, pad, pad)
    ws = torch.empty(o, dtype=torch.bfloat16, device="cuda")
    y = torch.ops.cspn_tpu_torch.int8_dequant(acc, s, ws, n, ho, wo, torch.bfloat16)
    return (s, a, acc, y), (ho, wo, kp, o)


@pytest.mark.parametrize("symbolic", [False, True], ids=["concrete", "symbolic"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_fakes_give_the_kernels_shapes(geometry, symbolic):
    """On fake CUDA tensors: the scale [N] bf16, A [max(N*Ho*Wo, 17), K']
    int8, the product [M', O'] int32 (`_int_mm`'s own checks of more than
    16 rows pass), the output [N, Ho, Wo, O] bf16 contiguous; with a
    symbolic N, the rows a Max() of it, and no guard added."""
    env = ShapeEnv()
    n = env.create_symintnode(env.create_symbol(3, ConstantSource("n")), hint=3) if symbolic else 3
    with FakeTensorMode(shape_env=env):
        (s, a, acc, y), (ho, wo, kp, o) = _fake_outputs(n, geometry)
    rows = max(3 * ho * wo, quant_cuda.MIN_ROWS)
    assert s.dtype == torch.bfloat16 and s.device.type == "cuda" and tuple(s.shape) == (n,)
    assert a.dtype == torch.int8 and a.shape[1] == kp and acc.dtype == torch.int32
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (n, ho, wo, o) and y.is_contiguous()
    if symbolic:
        assert "Max(17" in str(a.shape[0]) and not env.guards
        assert a.shape[0].node.hint == rows
    else:
        assert a.shape[0] == acc.shape[0] == rows


class _OneConv(torch.nn.Module):
    """One QuantConv on the card's route, on whatever device."""

    def __init__(self, static):
        super().__init__()
        self.qc = quant_conv(16, 24, 3, 2, 1, False, static)

    def forward(self, x):
        pads = [(ph, pw) for _, ph, pw in self.qc._convs(self.qc.weight)]
        convs = list(zip(self.qc.quantized_weights(), pads))
        return self.qc._products_kernels(x, self.qc._static_scale(x), convs)[0]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_export_with_a_symbolic_batch(tmp_path, static):
    """The route traces with a symbolic batch, on the fake implementations:
    each kernel one node (no act_absmax on static scales), `_int_mm` on
    the rows' Max(); the ops stay in the graph through a save and load."""
    module = _OneConv(static)
    dims = ({0: torch.export.Dim("b", min=1, max=64)},)
    with torch.no_grad():
        program = torch.export.export(module, (activation(2, 16, 5, 7),), dynamic_shapes=dims)
    want_ops = {"int8_taps": 1, "int8_dequant": 1, **({} if static else {"act_absmax": 1})}
    assert export.op_counts(program) == want_ops
    mm = [n for n in program.graph.nodes if n.target is torch.ops.aten._int_mm.default]
    assert len(mm) == 1 and "Max(17" in str(mm[0].args[0].meta["val"].shape[0])
    torch.export.save(program, tmp_path / "conv.pt2")
    assert export.op_counts(torch.export.load(tmp_path / "conv.pt2")) == want_ops


def _int8_model(preset):
    cfg = config.PRESETS[preset]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_steps=2, dtype="int8"))
    return evaluate.build_model(cfg, device="cpu")


@pytest.mark.parametrize("preset, want", [("nyu_eval", (64, 82)), ("synthetic_smoke", (31, 43))])
def test_kernel_launches_a_forward(preset, want, monkeypatch):
    """One forward's launches: an abs-max a QuantConv, taps and dequantize a
    product (a subpixel conv's four phases four, a reindexed one one), as a
    CPU forward counts its quantizations and products; no abs-max on
    static scales.  The BN epilogue on every dequantization once the BNs
    hold the serving weights' bf16 parameters, on none with float32 ones
    (their normalization is float32)."""
    model = _int8_model(preset)
    calls = {"quantize_tensor": 0, "int8_conv_prequant": 0}
    for name in calls:
        def counted(*args, _name=name, _fn=getattr(quant, name), **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(quant, name, counted)
    with torch.no_grad():
        model(torch.randn(1, 32, 48, 4))
    convs, products = want
    assert (calls["quantize_tensor"], calls["int8_conv_prequant"]) == want
    assert quant.kernel_launches(model) == {"act_absmax": convs, "int8_taps": products,
                                            "int8_dequant": products, "int8_dequant_bn": 0}
    model.load_state_dict(cast_floating(model.state_dict()), assign=True)
    assert quant.kernel_launches(model)["int8_dequant_bn"] == products
    for m in quant.quant_convs(model).values():
        m.act_max = torch.tensor(1.0)
    assert quant.kernel_launches(model)["act_absmax"] == 0


def test_cpu_forward_launches_nothing_and_the_server_counts_the_kernels():
    """A CPU forward takes the PyTorch route (the ops have no CPU
    implementation, so the card's route raises on CPU tensors)."""
    qc = quant_conv(16, 24, 3, 1, 1, False)
    x = activation(2, 16, 5, 7)
    before = (quant_cuda.absmax_launches, quant_cuda.taps_launches, quant_cuda.dequant_launches)
    with torch.no_grad():
        y = qc(x)
        convs = list(zip(qc.quantized_weights(), [((1, 1), (1, 1))]))
        assert torch.equal(y, qc._products_plain(x, None, convs)[0])
        with pytest.raises(NotImplementedError):
            qc._products_kernels(x, None, convs)
    assert (quant_cuda.absmax_launches, quant_cuda.taps_launches,
            quant_cuda.dequant_launches) == before
    for name in ("absmax_launches", "taps_launches", "dequant_launches", "dequant_bn_launches"):
        assert ("cspn_tpu_torch.ops.quant_cuda", name) in serving.LAUNCH_COUNTERS


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """Checked before any build: float32 or int32 activations, one not in
    channels-last memory, a product that is not int32, an output dtype
    other than bf16, a scale of another dtype or count."""
    x = activation(2, 16, 5, 7)
    scale = torch.ones(2, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        quant_cuda._launch_absmax(x.float())
    for launch in (quant_cuda._launch_absmax, lambda t: quant_cuda._launch_taps(
            t, scale, 3, 3, 1, 1, 1, 1, 1, 144)):
        with pytest.raises(ValueError, match="channels-last"):
            launch(x.contiguous())
    with pytest.raises(TypeError, match="bf16"):
        quant_cuda._launch_taps(x.int(), scale, 3, 3, 1, 1, 1, 1, 1, 144)
    with pytest.raises(TypeError, match="scales are bf16 or float32"):
        quant_cuda._launch_taps(x, scale.double(), 3, 3, 1, 1, 1, 1, 1, 144)
    with pytest.raises(ValueError, match="3 scales for 2 samples"):
        quant_cuda._launch_taps(x, torch.ones(3, dtype=torch.bfloat16), 3, 3, 1, 1, 1, 1, 1, 144)
    with pytest.raises(ValueError, match="K' 136"):
        quant_cuda._launch_taps(x, scale, 3, 3, 1, 1, 1, 1, 1, 136)
    acc = torch.zeros(70, 24, dtype=torch.int32)
    ws = torch.ones(24, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int32"):
        quant_cuda._launch_dequant(acc.float(), scale, ws, 2, 5, 7, torch.bfloat16)
    with pytest.raises(TypeError, match="writes bf16"):
        quant_cuda._launch_dequant(acc, scale, ws, 2, 5, 7, torch.float32)


# --- int8_dequant's BN epilogue (models/resnet.py:conv_bn) ---

EPILOGUES = {"bn": (False, False), "bn_relu": (False, True), "bn_residual": (True, False),
             "bn_residual_relu": (True, True)}


def serving_bn(c, seed=2):
    """An eval BatchNorm2d holding bf16 serving weights and seeded statistics."""
    gen = torch.Generator().manual_seed(seed)
    bn = resnet.BatchNorm2d(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.weight.copy_(torch.randn(c, generator=gen))
        bn.bias.copy_(torch.randn(c, generator=gen) * 0.1)
    return bn.to(torch.bfloat16).eval()


@pytest.mark.parametrize("symbolic", [False, True], ids=["concrete", "symbolic"])
@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_fake_of_the_epilogue_gives_the_output(epilogue, symbolic):
    """`int8_dequant` with the BN's three [O] parameters, a residual and a
    ReLU as asked, on fake CUDA tensors: [N, Ho, Wo, O] bf16 contiguous,
    as without them, for a concrete and a symbolic N (no guard added)."""
    residual, relu = EPILOGUES[epilogue]
    env = ShapeEnv()
    n = env.create_symintnode(env.create_symbol(3, ConstantSource("n")), hint=3) if symbolic else 3
    c, o, k, stride, pad, _, _, h, w = GEOMETRIES["3x3_s2"]
    kp = -(-k * k * c // 8) * 8
    with FakeTensorMode(shape_env=env):
        (s, _, acc, y), (ho, wo, _, _) = _fake_outputs(n, "3x3_s2")
        params = [torch.empty(o, dtype=torch.bfloat16, device="cuda") for _ in range(3)]
        r = torch.empty(n, ho, wo, o, dtype=torch.bfloat16, device="cuda").permute(0, 3, 1, 2)
        ws = torch.empty(o, dtype=torch.bfloat16, device="cuda")
        fused = torch.ops.cspn_tpu_torch.int8_dequant(
            acc, s, ws, n, ho, wo, torch.bfloat16, *params, residual=r if residual else None,
            relu=relu)
    assert fused.dtype == y.dtype == torch.bfloat16 and fused.is_contiguous()
    assert tuple(fused.shape) == tuple(y.shape) == (n, ho, wo, o) and kp % 8 == 0
    if symbolic:
        assert not env.guards


class _OneBlock(torch.nn.Module):
    """A QuantConv + BN + residual + ReLU on the card's route, on whatever
    device: the end of a ResNet block with the epilogue."""

    def __init__(self, static):
        super().__init__()
        self.qc = quant_conv(16, 24, 3, 2, 1, False, static)
        self.bn = serving_bn(24)

    def forward(self, x, r):
        pads = [(ph, pw) for _, ph, pw in self.qc._convs(self.qc.weight)]
        convs = list(zip(self.qc.quantized_weights(), pads))
        return self.qc._products_kernels(x, self.qc._static_scale(x), convs,
                                         self.bn.bf16_params(x.dtype), r, True)[0]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_epilogue_block_exports_with_a_symbolic_batch(tmp_path, static):
    """The block traces with a symbolic batch: one `int8_dequant` node that
    takes the BN's parameters, the residual and relu=True (no BN, add or
    ReLU node of its own after it); the ops stay through a save and
    load."""
    module = _OneBlock(static)
    b = torch.export.Dim("b", min=1, max=64)
    x, r = activation(2, 16, 5, 7), activation(2, 24, 3, 4, seed=3)
    with torch.no_grad():
        program = torch.export.export(module, (x, r), dynamic_shapes=({0: b}, {0: b}))
    want_ops = {"int8_taps": 1, "int8_dequant": 1, **({} if static else {"act_absmax": 1})}
    assert export.op_counts(program) == want_ops
    (node,) = [n for n in program.graph.nodes
               if n.target is torch.ops.cspn_tpu_torch.int8_dequant.default]
    mean, mul, bias, residual, relu = node.args[7:]
    assert (mean.name, bias.name, residual.name, relu) == ("b_bn_running_mean", "p_bn_bias", "r",
                                                           True)
    assert mul.target is torch.ops.aten.mul.Tensor
    assert [n.target for n in node.users] == [torch.ops.aten.permute.default]
    torch.export.save(program, tmp_path / "block.pt2")
    assert export.op_counts(torch.export.load(tmp_path / "block.pt2")) == want_ops


def _epilogue_on_any_device(conv, bn, x):
    """resnet.bn_epilogue without its CUDA condition: a QuantConv's epilogue
    on CPU tensors too."""
    return bn.bf16_params(x.dtype) if isinstance(conv, quant.QuantConv) else None


def _old_forward(block, *args):
    """The blocks' forwards before the epilogue, op by op."""
    relu = torch.relu
    if isinstance(block, resnet.Bottleneck):
        (x,) = args
        out = relu(block.bn1(block.conv1(x)))
        out = relu(block.bn2(block.conv2(out)))
        out = block.bn3(block.conv3(out))
        return relu(out + (x if block.downsample is None else block.downsample(x)))
    if isinstance(block, resnet.BasicBlock):
        (x,) = args
        out = relu(block.bn1(block.conv1(x)))
        out = block.bn2(block.conv2(out))
        return relu(out + (x if block.downsample is None else block.downsample(x)))
    x, *side, oh, ow = args
    out, sc = block.conv1(x, oh, ow), block.sc_conv1(x, oh, ow)
    out = relu(block.bn1(out))
    if side:
        out = relu(block.bn1_1(block.conv1_1(torch.cat([out, side[0]], dim=1))))
    out = block.bn2(block.conv2(out))
    return relu(out + block.sc_bn1(sc))


BLOCKS = {
    "bottleneck_downsample": (lambda: resnet.Bottleneck(32, 8, 2, True), [(2, 32, 9, 11)]),
    "basic": (lambda: resnet.BasicBlock(16, 16), [(2, 16, 7, 9)]),
    "basic_downsample": (lambda: resnet.BasicBlock(16, 24, 2, True), [(2, 16, 7, 9)]),
    # features 128: four phase kernels; 64: one reindexed kernel (the BN tiled 4x)
    "gudi_up_proj": (lambda: decoder.GudiUpProj(32, 128), [(1, 32, 4, 5)]),
    "gudi_up_proj_cat": (lambda: decoder.GudiUpProjCat(32, 8, 64), [(1, 32, 4, 5), (1, 8, 7, 9)]),
}


def _serving_block(kind):
    make, shapes = BLOCKS[kind]
    torch.manual_seed(0)
    block = quant.quantize_convs(make())
    for i, bn in enumerate(m for m in block.modules() if isinstance(m, resnet.BatchNorm2d)):
        bn.load_state_dict(serving_bn(bn.num_features, seed=i).state_dict())
    block = block.to(torch.bfloat16).eval()
    quant.build_weight_qcache(block)
    gen = torch.Generator().manual_seed(5)
    args = [torch.randn(s, generator=gen).to(torch.bfloat16) for s in shapes]
    if isinstance(block, decoder._UnpoolBlock):
        args += [7, 9]
    return block, args


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_blocks_on_the_cpu_take_todays_ops(kind, monkeypatch):
    """On CPU tensors `conv_bn` hands no QuantConv an epilogue: each block's
    output equals its forward before the epilogue existed, bit for bit.
    Handed one on the CPU too, QuantConv applies it op by op after the
    PyTorch route's products (a subpixel conv on each phase before
    depth_to_space2, the reindexed kernel's BN tiled to its four phase
    groups), with the same bits."""
    block, args = _serving_block(kind)
    handed = []
    forward = quant.QuantConv.forward

    def spy(self, x, *a, bn=(), residual=None, relu=False):
        handed.append(bool(bn))
        return forward(self, x, *a, bn=bn, residual=residual, relu=relu)

    monkeypatch.setattr(quant.QuantConv, "forward", spy)
    with torch.no_grad():
        want = _old_forward(block, *args)
        handed.clear()
        got = block(*args)
        assert handed and not any(handed)
        handed.clear()
        monkeypatch.setattr(resnet, "bn_epilogue", _epilogue_on_any_device)
        fused = block(*args)
    assert all(handed) and len(handed) == len(quant.quant_convs(block))
    assert torch.equal(got, want) and torch.equal(fused, want)


def test_model_with_the_epilogue_on_the_cpu_equals_todays(monkeypatch):
    """The KITTI-style ResNet-18 int8 CSPN-UNet (synthetic_smoke) with every
    QuantConv handed its epilogue (as on the card; here QuantConv's PyTorch
    route applies it) equals the CPU forward, which runs the BNs op by op:
    43 products with the epilogue, 11 residuals, bit for bit."""
    model = _int8_model("synthetic_smoke")
    model.load_state_dict(cast_floating(model.state_dict()), assign=True)
    for i, bn in enumerate(m for m in model.modules() if isinstance(m, resnet.BatchNorm2d)):
        bn.load_state_dict(serving_bn(bn.num_features, seed=i).state_dict())
    x = torch.randn(2, 32, 48, 4, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = model(x)
        calls = []
        products = quant.QuantConv._products_plain

        def spy(self, x, scale, convs, bn=(), residual=None, relu=False):
            calls.append((len(bn), residual is not None))
            return products(self, x, scale, convs, bn, residual, relu)

        monkeypatch.setattr(quant.QuantConv, "_products_plain", spy)
        monkeypatch.setattr(resnet, "bn_epilogue", _epilogue_on_any_device)
        got = model(x)
    assert len(calls) == 31 and all(n == 3 for n, _ in calls)
    assert sum(r for _, r in calls) == 11
    assert torch.equal(got, want)


def test_epilogue_wrappers_raise_on_what_the_kernel_does_not_take():
    """Checked before any build: a residual or a ReLU without the BN, BN
    parameters of another dtype or count, a residual of another shape;
    QuantConv refuses a residual on a subpixel conv."""
    acc = torch.zeros(70, 24, dtype=torch.int32)
    scale = torch.ones(2, dtype=torch.bfloat16)
    ws = torch.ones(24, dtype=torch.bfloat16)
    r = torch.zeros(2, 24, 5, 7, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="follow the BN"):
        quant_cuda._launch_dequant(acc, scale, ws, 2, 5, 7, torch.bfloat16, relu=True)
    with pytest.raises(ValueError, match="follow the BN"):
        quant_cuda._launch_dequant(acc, scale, ws, 2, 5, 7, torch.bfloat16, residual=r)
    with pytest.raises(ValueError, match=r"\(mean, mul, bias\) are bf16 \[24\]"):
        quant_cuda._launch_dequant(acc, scale, ws, 2, 5, 7, torch.bfloat16, [ws, ws, ws.float()])
    with pytest.raises(ValueError, match=r"\(mean, mul, bias\) are bf16 \[24\]"):
        quant_cuda._launch_dequant(acc, scale, ws, 2, 5, 7, torch.bfloat16, [ws, ws, ws[:8]])
    with pytest.raises(ValueError, match=r"residual is bf16 \[2, 24, 5, 7\]"):
        quant_cuda._launch_dequant(acc, scale, ws, 2, 5, 7, torch.bfloat16, [ws] * 3, r[:, :, :4])
    qc = quant_conv(16, 128, 5, 1, 2, True)
    bn = serving_bn(128).bf16_params(torch.bfloat16)
    x = activation(1, 16, 4, 5)
    with pytest.raises(ValueError, match="no residual"), torch.no_grad():
        qc(x, 7, 9, bn=bn, residual=torch.zeros(1, 128, 7, 9, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="follow its BN"), torch.no_grad():
        qc(x, 7, 9, relu=True)
