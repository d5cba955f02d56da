"""int8 serving quantization (utils/quant.py, the `quant` of models/unet.py,
train/evaluate.py:load_eval_state at dtype 'int8') against the JAX
package's cspn_tpu/utils/quant.py -- the counterparts of tests/test_quant.py.

Inputs come from numpy seeds, weights from the JAX init through
models/convert.py.  Tolerances:
  - quantize_tensor / quantize_weights, and the load-time weight cache
    against JAX's quantize_weights of the same kernels (HWIO -> OIHW, the
    subpixel decoder's four phase kernels included): bit for bit, int8
    values and scales; against JAX's jitted cache, one int8 step (trap 4:
    test_weight_cache_matches_jax);
  - the int8 conv on integer inputs within +-127: exact (int32 sums);
  - one QuantConv on the same bf16 input: rel-norm 1e-6 (both dequantize
    the same int32 sums with the same scales into bf16; measured 0);
  - the whole int8 CSPN-UNet against JAX's: bf16 rounding amplified by the
    random network (trap 5) reaches the quantizers' inputs, and a flipped
    rounding moves a value by a whole int8 step, each layer's flips making
    more in the next, so the two int8 outputs drift as far apart as either
    is from the bf16 one (measured 0.052 apart; 0.043 from JAX's bf16
    output, JAX's own int8 0.042).  The port is held within twice JAX's
    int8-vs-bf16 distance of JAX's int8 output, and at least half that
    distance away from JAX's bf16 output (a model without int8 convs sits
    0.004 from it), all below JAX's 0.08 bound of int8 against float
    (tests/test_quant.py:68-81);
  - the cached weights against quantizing at every call: rel-norm 1e-3
    (ROADMAP.md Queue 3, trap 4; here they are equal);
  - the calibrated static scales against JAX's 'acal': 5e-2 per site
    (each is an abs-max of a bf16 activation computed by each package);
    the output on them as the int8 model's, and at least half as far from
    the port's dynamic-scale output as JAX's static output is from its
    dynamic one (measured 0.048 and 0.045).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cspn_tpu.models import decoder as jdecoder
from cspn_tpu.models import unet as junet
from cspn_tpu.utils import quant as jquant
from cspn_tpu.utils.precision import cast_floating as jcast_floating
from cspn_tpu_torch import config
from cspn_tpu_torch.models import convert, decoder, unet
from cspn_tpu_torch.train import evaluate
from cspn_tpu_torch.utils import quant

torch.set_num_threads(1)

BF16 = jnp.bfloat16
HW = (32, 48)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(a) -> np.ndarray:
    """A JAX or torch array as numpy (bf16 widened to float32)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 else a.detach().numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == BF16 else a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6, 7, 8)).astype(np.float32) * np.array([1, 1e-3, 40])[:, None, None, None]
    # ties: sample 0's abs-max is 127 (scale 1), so k + 0.5 rounds to even
    x[0, 0, 0, :] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.5]
    x = _np(jnp.asarray(x, dtype))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    jq, js = jquant.quantize_tensor(jx)
    q, s = quant.quantize_tensor(tx)
    assert q.dtype == torch.int8 and s.dtype == tx.dtype and s.shape == (3, 1, 1, 1)
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(s).ravel(), _np(js).ravel())
    assert q.abs().max() <= 127 and q[0, :, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, -126, 4]
    scale = np.float32(0.37)
    jq, _ = jquant.quantize_tensor_static(jx, jnp.float32(scale))
    q, _ = quant.quantize_tensor_static(tx, torch.tensor(scale))
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(jq))
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel: scale 1 / 127
    w = _np(jnp.asarray(w, dtype))
    jwq, jws = jquant.quantize_weights(jnp.asarray(w, dtype))
    wq, ws = quant.quantize_weights(torch.from_numpy(w.transpose(3, 2, 0, 1)).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(_np(ws), _np(jws))


@pytest.mark.parametrize("stride, hw", [(1, (10, 12)), (2, (10, 12)), (1, (2, 3))])
def test_int8_conv_exact_on_integer_inputs(stride, hw):
    """Integer inputs within +-127 with both scales pinned to 1 quantize
    losslessly, so the int8 conv equals the float conv exactly; (2, 3) has
    6 rows a sample, padded up for _int_mm."""
    rng = np.random.default_rng(stride)
    x = rng.integers(-127, 128, (2, 8, *hw)).astype(np.float32)
    w = rng.integers(-127, 128, (16, 8, 3, 3)).astype(np.float32)
    x[:, 0, 0, 0] = 127.0
    w[:, 0, 0, 0] = 127.0
    conv = torch.nn.Conv2d(8, 16, 3, stride=stride, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    qc = quant.QuantConv(conv)
    assert qc.weight is conv.weight
    got = qc(torch.from_numpy(x))
    want = F.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(), stride=stride,
                    padding=1)
    assert got.dtype == torch.float32 and torch.equal(got.double(), want)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 12)).astype(np.int8))
    wm = quant.weight_matrix(torch.from_numpy(rng.integers(-127, 128, (3, 12, 1, 1)).astype(np.int8)))
    assert wm.shape == (8, 16)  # N and K padded to multiples of 8
    assert torch.equal(quant.int8_matmul(a, wm, 3), (a.int() @ wm[:3, :12].int().t()))


def test_quantconv_matches_jax():
    rng = np.random.default_rng(1)
    x = _np(jnp.asarray(rng.standard_normal((2, 12, 16, 8)), BF16))
    jqc = jquant.QuantConv(16, 3, dtype=BF16)
    v = jax.tree.map(np.asarray, jqc.init(jax.random.PRNGKey(0), jnp.asarray(x, BF16)))
    want = jqc.apply(jcast_floating(v), jnp.asarray(x, BF16))
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(v["params"]["kernel"].transpose(3, 2, 0, 1)))
    qc = quant.QuantConv(conv).to(torch.bfloat16)
    got = qc(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    assert _rel(_np(got).transpose(0, 2, 3, 1), _np(want)) < 1e-6


@pytest.mark.parametrize("k, cin, cout", [(5, 16, 128), (3, 8, 32)])
def test_int8_subpixel_phase_split_identical_to_fused(k, cin, cout):
    """From 128 output channels the int8 subpixel conv runs the four exact
    phase kernels, each quantized per its own channels: bit for bit the
    int8 conv of the zero-padded reindexed kernel (structural zeros change
    neither a channel's abs-max nor the int32 sums)."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((2, cin, 6, 7)).astype(np.float32))
    conv = decoder.SubpixelUnpoolConv(cin, cout, k)
    torch.nn.init.normal_(conv.weight, generator=torch.Generator().manual_seed(k))
    qc = quant.QuantConv(conv, subpixel=True)
    got = qc(x, 11, 13)
    fused = decoder._subpixel_weights(conv.weight, k)
    xq, xs = quant.quantize_tensor(x)
    wq, ws = quant.quantize_weights(fused)
    pad = (1, 1) if k >= 5 else (0, 1)
    y = quant.int8_conv_prequant(xq, xs, wq, ws, 1, (pad, pad), x.dtype)
    assert len(qc.quantized_weights()) == (4 if cout >= 128 else 1)
    assert torch.equal(got, decoder.depth_to_space2(y.contiguous(), 11, 13))


@pytest.fixture(scope="module")
def int8_models():
    """JAX's int8 CSPN-UNet (ResNet-18, bf16, quant) on its init cast to
    bf16, its weight cache and calibration, and the port's load_eval_state
    at dtype 'int8' on the same weights: one 64x96 frame, JAX's own setting
    (tests/test_quant.py:68-81, eval-mode BN at the init statistics)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 64, 96, 4)).astype(np.float32)
    jx = jnp.asarray(x)
    kw = dict(cspn_steps=2, cspn_backend="reference")
    v = jax.tree.map(np.asarray, jax.jit(junet._make(18, True, **kw).init)(
        jax.random.PRNGKey(0), jx))
    vb = jcast_floating(v)
    mq = junet._make(18, True, dtype=BF16, quant=True, **kw)
    mb = junet._make(18, True, dtype=BF16, **kw)
    qc = jquant.build_weight_qcache(mq, vb, jx)
    acal = jquant.build_act_calibration(mq, dict(vb, qcache=qc), [jx])
    out = {"int8": jax.jit(mq.apply)(dict(vb, qcache=qc), jx),
           "static": jax.jit(mq.apply)(dict(vb, qcache=qc, acal=acal), jx),
           "bf16": jax.jit(mb.apply)(vb, jx),
           "f32": jax.jit(junet._make(18, True, **kw).apply)(v, jx)}
    cfg = config.PRESETS["synthetic_smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_steps=2, dtype="int8"))
    model = evaluate.load_eval_state(cfg, device="cpu", jax_variables=v)
    return x, v, qc, acal, {k: _np(o) for k, o in out.items()}, model


def _port_name(path) -> str:
    """The port's module of a JAX qcache / acal leaf path."""
    return convert.port_key("params", (*path[:-1], "kernel"))[: -len(".weight")]


def test_weight_cache_matches_jax(int8_models):
    """Every cached conv, the subpixel decoder's four phase kernels
    included, bit for bit JAX's quantize_weights of the same bf16 kernel
    (its _phase_kernel / _subpixel_weights reindex where it caches those).
    JAX's build_weight_qcache itself runs that quantizer under jit, where
    XLA multiplies by the scale's reciprocal: the scales are equal, but
    rounding a tie of w / scale (common among bf16 values) can come out one
    step apart (trap 4; measured on 11% of a 3x3x512x512 kernel's values),
    so against it each value is held within one step."""
    _, v, jcache, _, _, model = int8_models
    convs = quant.quant_convs(model)
    params = jcast_floating(v)["params"]
    leaves = {}

    def walk(node, pnode, path):
        for k, child in node.items():
            if k == "wq_ws":
                leaves[_port_name((*path, k))] = (child, np.asarray(pnode["kernel"]))
            else:
                walk(child, pnode[k], (*path, k))

    walk(jax.tree.map(np.asarray, jcache), params, ())
    assert set(leaves) == set(convs) and len(leaves) >= 8
    assert "conv1_1" not in leaves and not any(k.startswith(("gud_up_proj_layer4",
                                                             "gud_up_proj_layer5")) for k in leaves)
    n_phase = 0
    for name, (jpairs, kernel) in leaves.items():
        kernel = jnp.asarray(kernel, BF16)
        k = kernel.shape[0]
        if isinstance(jpairs[0], tuple):  # the phase-split decoder conv, px-major
            n_phase += 1
            kernels = [jdecoder._phase_kernel(kernel, k, px, py) for px in range(2) for py in range(2)]
        elif jpairs[0].shape != kernel.shape:  # the zero-padded reindexed kernel
            kernels, jpairs = [jdecoder._subpixel_weights(kernel, k)], (jpairs,)
        else:
            kernels, jpairs = [kernel], (jpairs,)
        pairs = convs[name].qcache
        assert len(pairs) == len(jpairs) == len(kernels), name
        for (wq, ws, _), (jwq, jws), kern in zip(pairs, jpairs, kernels):
            ewq, ews = jquant.quantize_weights(kern)
            np.testing.assert_array_equal(wq.numpy(), np.asarray(ewq).transpose(3, 2, 0, 1),
                                          err_msg=name)
            np.testing.assert_array_equal(_np(ws), _np(ews), err_msg=name)
            np.testing.assert_array_equal(_np(ws), _np(jnp.asarray(jws)), err_msg=name)
            assert np.abs(wq.numpy().astype(int) - jwq.transpose(3, 2, 0, 1)).max() <= 1, name
    assert n_phase >= 2


def test_int8_model_matches_jax(int8_models):
    x, _, _, _, want, model = int8_models
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all() and got.shape == x.shape[:3]
    bound = _rel(want["int8"], want["bf16"])
    assert 0 < bound < 0.08 and _rel(want["int8"], want["f32"]) < 0.08
    assert _rel(got, want["int8"]) < min(2 * bound, 0.08)
    assert _rel(got, want["bf16"]) > 0.5 * bound  # the int8 convs moved it off bf16


def test_cached_weights_equal_quantizing_each_call(int8_models):
    x, _, _, _, _, model = int8_models
    convs = quant.quant_convs(model)
    with torch.no_grad():
        cached = model(torch.from_numpy(x))
        caches = {k: m.qcache for k, m in convs.items()}
        for m in convs.values():
            m.qcache = None
        dynamic = model(torch.from_numpy(x))
        for k, m in convs.items():
            m.qcache = caches[k]
    assert _rel(cached.numpy(), dynamic.numpy()) < 1e-3


def test_static_calibration_matches_jax(int8_models):
    x, _, _, jacal, want, model = int8_models
    with torch.no_grad():
        dynamic = model(torch.from_numpy(x)).numpy()
    acal = quant.build_act_calibration(model, [torch.from_numpy(x)])
    try:
        leaves = {}

        def walk(node, path):
            for k, child in node.items():
                if k == "xmax":
                    leaves[_port_name((*path, k))] = float(np.asarray(child))
                else:
                    walk(child, (*path, k))

        walk(jacal, ())
        assert set(leaves) == set(acal)
        for name, xmax in leaves.items():
            assert acal[name].dtype == torch.float32
            np.testing.assert_allclose(acal[name].item(), xmax, rtol=5e-2, err_msg=name)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        bound = _rel(want["static"], want["bf16"])
        assert _rel(got, want["static"]) < min(2 * bound, 0.08)
        # the static scales, not the dynamic ones, quantized the activations
        assert _rel(got, dynamic) > 0.5 * _rel(want["static"], want["int8"])
    finally:
        for m in quant.quant_convs(model).values():
            m.act_max = None


def test_quant_is_serving_only():
    cfg = config.PRESETS["synthetic_smoke"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_steps=2, dtype="int8"))
    train = evaluate.build_model(cfg, train=True, device="cpu")
    assert train.dtype == torch.bfloat16 and not train.quant and not quant.quant_convs(train)
    serve = evaluate.build_model(cfg, device="cpu")
    assert serve.quant and not serve.training
    assert set(serve.state_dict()) == set(train.state_dict())  # one checkpoint serves both
    with pytest.raises(ValueError, match="serving-only"):
        serve.train()
    excluded = unet.cspn_unet_resnet18(cspn_steps=2, quant=True,
                                       quant_exclude=("encoder", "gud_up_proj_layer4"))
    names = set(quant.quant_convs(excluded))
    assert names and all(n.startswith(("gud_up_proj_layer1", "gud_up_proj_layer2",
                                       "gud_up_proj_layer3")) for n in names)
