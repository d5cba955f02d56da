"""The 2D CSPN on bf16 inputs (the bf16 HBM-input variant of
cspn_tpu/ops/cspn_pallas.py:_fwd_kernel; csrc/cspn2d_tiled.cu:
cspn2d_tiled_io on the card) against the JAX package's kernel run with
`io_dtype=jnp.bfloat16` in interpret mode, as tests/test_cspn_pallas.py
runs it.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3).  Here the port's side is its plain version
(ops/cspn.py:_reference, the custom op's CPU kernel): bf16 inputs read as
their float32 upcast, float32 ones under `io_dtype` bfloat16 rounded
through bf16 first.  The kernel rounds in registers with cuda_bf16.h's
`__float2bfloat16_rn`; a numpy emulation of that rounding, from the
float's bits, is held bit for bit to `Tensor.to(torch.bfloat16)` and to
`astype(jnp.bfloat16)`.  The models hand their bf16 heads to the CSPN as
they are (models/unet.py:cspn_input_dtype); a twin promoting them to
float32 first, as before, gives the same output and gradients bit for bit.

Inputs come from numpy seeds.  Tolerances: the port's plain version
against JAX's kernel rtol and atol 1e-5, JAX's own for its bf16-I/O
kernel (tests/test_cspn_pallas.py:198); everything else bit for bit.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.ops.cspn_pallas import cspn2d_pallas
from cspn_tpu_torch import export
from cspn_tpu_torch.models import unet
from cspn_tpu_torch.ops import cspn_cuda, cspn_ref
from cspn_tpu_torch.ops.cspn import _round_io, cspn2d

torch.set_num_threads(1)

BF16 = torch.bfloat16
TOL = 1e-5


def _inputs(seed, n, h, w, with_sparse=True):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, 8, h, w)).astype(np.float32)
    b = (rng.random((n, h, w)) * 5).astype(np.float32)
    s = None
    if with_sparse:
        s = np.where(rng.random((n, h, w)) < 0.1, rng.standard_normal((n, h, w)), 0.0).astype(
            np.float32)
    return g, b, s


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _jax_bf16_io(g, b, s, steps, norm):
    """JAX's Pallas kernel, interpret mode, bf16 HBM inputs."""
    return np.asarray(cspn2d_pallas(jnp.asarray(g), jnp.asarray(b), None if s is None else
                                    jnp.asarray(s), steps=steps, norm_type=norm, interpret=True,
                                    channel_first=True, io_dtype=jnp.bfloat16))


@pytest.mark.parametrize("norm", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("shape", [(2, 13, 17), (1, 45, 70)])
def test_bf16_inputs_match_jax_bf16_io(shape, with_sparse, norm):
    """bf16 inputs, and float32 inputs at io_dtype bfloat16, through the
    port's 2D CSPN (the plain version on the CPU) against JAX's kernel with
    bf16 HBM inputs; the two input dtypes give the same output."""
    g, b, s = _inputs(sum(shape) + with_sparse, *shape, with_sparse)
    want = _jax_bf16_io(g, b, s, 24, norm)
    from_bf16 = cspn2d(_t(g, BF16), _t(b, BF16), _t(s, BF16), steps=24, norm_type=norm,
                       channel_first=True)
    from_f32 = cspn2d(_t(g), _t(b), _t(s), steps=24, norm_type=norm, channel_first=True,
                      io_dtype="bfloat16")
    assert from_bf16.dtype == from_f32.dtype == torch.float32
    np.testing.assert_allclose(from_bf16.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.equal(from_bf16, from_f32)
    # bf16 inputs need no io_dtype: rounding bf16 through bf16 is the identity
    assert torch.equal(from_bf16, cspn2d(_t(g, BF16), _t(b, BF16), _t(s, BF16), steps=24,
                                         norm_type=norm, channel_first=True, io_dtype="bfloat16"))


def test_mixed_input_dtypes_match_jax_bf16_io():
    """The served bf16 model's inputs: bf16 heads and a float32 sparse map.
    At io_dtype bfloat16 the sparse map is rounded too (JAX's function);
    without it, it is read as it is."""
    g, b, s = _inputs(3, 2, 13, 17)
    got = cspn2d(_t(g, BF16), _t(b, BF16), _t(s), steps=24, channel_first=True,
                 io_dtype=BF16)
    np.testing.assert_allclose(got.numpy(), _jax_bf16_io(g, b, s, 24, "8sum"), rtol=TOL, atol=TOL)
    plain = cspn_ref.cspn2d_reference(_t(g, BF16).float().movedim(1, -1), _t(b, BF16).float(),
                                      _t(s), steps=24)
    assert torch.equal(cspn2d(_t(g, BF16), _t(b, BF16), _t(s), steps=24, channel_first=True),
                       plain)


def _round_bf16_bits(x: np.ndarray) -> np.ndarray:
    """cuda_bf16.h's __float2bfloat16_rn (round to nearest, ties to even)
    then __bfloat162float, from the float's bits: the in-register rounding
    of csrc/cspn2d_common.cuh:io_value.  NaN is not rounded here."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return (r & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def test_in_register_rounding_is_torch_and_jax_rounding():
    rng = np.random.default_rng(0)
    f32 = np.finfo(np.float32)
    special = np.array([
        0.0, -0.0, 1.0, -1.0,
        1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8), 1 + 2**-8 + 2**-23,  # ties to even, past a tie
        1 + 2**-9, 255.5, 256.5, 257.5,
        f32.max, -f32.max, np.inf, -np.inf,  # the largest finite floats round to inf
        3.3895314e38, 3.3961776e38, -3.3961776e38,  # bf16's largest, and a tie above it
        f32.tiny, -f32.tiny, f32.smallest_subnormal, -f32.smallest_subnormal,
        1e-40, -1e-40, 9.18355e-41, 2.0**-133, 2.0**-133 * 1.5, 2.0**-126 * (1 - 2**-8),
        65504.0, 1e-8, 3.14159265,
    ], dtype=np.float32)
    bits = rng.integers(0, 2**32, size=20000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    bits = bits[~np.isnan(bits)]
    with np.errstate(over="ignore"):  # past the float32 range: inf
        wide = (rng.standard_normal(20000) * np.exp(rng.standard_normal(20000) * 30)).astype(
            np.float32)
    for x in (special, bits, wide):
        want = _round_bf16_bits(x)
        via_torch = torch.from_numpy(x).to(BF16).float().numpy()
        via_jax = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(want.view(np.uint32), via_torch.view(np.uint32))
        assert np.array_equal(want.view(np.uint32), via_jax.view(np.uint32))
    assert np.isinf(_round_bf16_bits(np.array([f32.max], np.float32))).all()


def test_custom_op_on_cpu_bf16_inputs_is_the_plain_version():
    """The op's CPU kernel on bf16 inputs and on float32 ones at io_dtype
    bfloat16: the plain version on the upcast, rounded inputs; the
    launch counter stays put (it counts the card's kernel)."""
    g, b, s = _inputs(5, 2, 9, 11)
    rounded = [t.to(BF16).float() for t in (_t(g), _t(b), _t(s))]
    want = cspn_ref.cspn2d_reference(rounded[0].movedim(1, -1), *rounded[1:], steps=5,
                                     norm_type="8sum_abs")
    before = cspn_cuda.tiled_launches
    op = torch.ops.cspn_tpu_torch.cspn2d_tiled
    for args in [(_t(g, BF16), _t(b, BF16), _t(s, BF16)), (_t(g, BF16), _t(b, BF16), _t(s))]:
        assert torch.equal(op(*args, 5, "8sum_abs", BF16), want)
    assert torch.equal(op(_t(g), _t(b), _t(s), 5, "8sum_abs", BF16), want)
    assert torch.equal(op(_t(g, BF16), _t(b, BF16), None, 0, "8sum"), _t(b, BF16).float())
    assert cspn_cuda.tiled_launches == before


def test_opcheck_on_bf16_inputs():
    g, b, s = _inputs(6, 2, 6, 7)
    for args in [(_t(g, BF16), _t(b, BF16), _t(s, BF16), 3, "8sum", None),
                 (_t(g, BF16), _t(b, BF16), _t(s), 3, "8sum_abs", BF16),
                 (_t(g), _t(b), None, 2, "8sum", BF16)]:
        torch.library.opcheck(torch.ops.cspn_tpu_torch.cspn2d_tiled, args)


def test_io_codes_say_how_the_kernel_reads_each_input():
    g, b, s = _t(np.zeros((1, 8, 2, 2), np.float32)), _t(np.zeros((1, 2, 2), np.float32)), None
    f32, rnd, bf = cspn_cuda.IO_F32, cspn_cuda.IO_F32_ROUND, cspn_cuda.IO_BF16
    assert cspn_cuda.io_codes(g, b, s) == (f32, f32, f32)
    assert cspn_cuda.io_codes(g, b, s, "float32") == (f32, f32, f32)
    assert cspn_cuda.io_codes(g, b, s, "bfloat16") == (rnd, rnd, rnd)
    assert cspn_cuda.io_codes(g.to(BF16), b.to(BF16), b, BF16) == (bf, bf, rnd)
    assert cspn_cuda.io_codes(g.to(BF16), b, None) == (bf, f32, f32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cspn_cuda.io_codes(g, b, s, torch.float16)


def _bf16_model(quant=False, io_dtype=None):
    gen = torch.Generator().manual_seed(0)
    return unet.cspn_unet_resnet18(cspn_steps=3, generator=gen, dtype=BF16, quant=quant,
                                   cspn_io_dtype=io_dtype)


def _promoting(monkeypatch):
    """The heads promoted to float32 before the CSPN, as the model did."""
    monkeypatch.setattr(unet, "cspn_input_dtype",
                        lambda dtype: torch.promote_types(dtype, torch.float32))


def _rgbd(seed, n=2, h=32, w=48):
    rng = np.random.default_rng(seed)
    x = rng.random((n, h, w, 4)).astype(np.float32)
    x[..., 3] *= rng.random((n, h, w)) < 0.1
    return torch.from_numpy(x)


@pytest.mark.parametrize("io_dtype", [None, "bfloat16"])
def test_bf16_heads_equal_promoted_heads_bit_for_bit(io_dtype, monkeypatch):
    """A train-mode bf16 CSPN-UNet hands its bf16 heads to the CSPN; its
    twin promotes them to float32 first.  Output and every gradient equal
    bit for bit: the CSPN reads bf16 as its exact upcast."""
    model = _bf16_model(io_dtype=io_dtype).train()
    twin = copy.deepcopy(model)
    x, ct = _rgbd(1), torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 48)).astype(np.float32))

    def run(m):
        out = m(x)
        grads = torch.autograd.grad((out * ct).sum(), list(m.parameters()))
        return out, grads

    out, grads = run(model)
    with monkeypatch.context() as mp:
        _promoting(mp)
        out_twin, grads_twin = run(twin)
    assert out.dtype == torch.float32 and torch.equal(out, out_twin)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_twin))


def test_int8_model_hands_bf16_heads_as_they_are(monkeypatch):
    """The int8 model's heads are bf16 too: the same output as its twin
    promoting them, and the heads reach the CSPN in bf16."""
    model = _bf16_model(quant=True, io_dtype="bfloat16").eval()
    twin = copy.deepcopy(model)
    seen = []
    real = unet.cspn2d

    def spy(g, b, s, **kw):
        seen.append((g.dtype, b.dtype))
        return real(g, b, s, **kw)

    monkeypatch.setattr(unet, "cspn2d", spy)
    x = _rgbd(3)
    with torch.no_grad():
        out = model(x)
        with monkeypatch.context() as mp:
            _promoting(mp)
            want = twin(x)
    assert seen == [(BF16, BF16), (torch.float32, torch.float32)]
    assert torch.equal(out, want)


_VIEWS = ("slice", "select", "clone", "alias", "view", "permute", "contiguous", "expand")


def _passes_through(node) -> bool:
    """A view or copy, or a `to` that keeps its input's dtype (an alias)."""
    target = str(node.target)
    if "aten.to." in target:
        return node.args[0].meta["val"].dtype == node.meta["val"].dtype
    return any(v in target for v in _VIEWS)


def _cspn_input_producers(program):
    """For the cspn2d_tiled node's guidance and blur: the nodes on the way
    back from it through views, copies and aliases, and the first node past
    them (the heads)."""
    node = next(n for n in program.graph.nodes if n.op == "call_function"
                and getattr(n.target, "name", lambda: "")().startswith("cspn_tpu_torch::cspn2d_tiled"))
    paths = []
    for arg in node.args[:2]:
        path = [arg]
        while _passes_through(path[-1]):
            path.append(path[-1].args[0])
        paths.append(path)
    return node, paths


def test_export_hands_bf16_heads_to_the_cspn_node(monkeypatch):
    """A bf16 model with cspn_io_dtype bfloat16, exported with its CSPN on
    the `cspn2d_tiled` op as on the card (the route cspn2d_cuda takes when
    no backward follows; on the CPU the model's CSPN is otherwise the plain
    version): no float32 cast lies between the heads and the node, which
    takes bf16 guidance and blur and the I/O dtype.  The twin promoting the
    heads shows the float32 cast the check looks for."""
    def via_op(g, b, s, *, steps, norm_type, backend, io_dtype, channel_first):
        assert channel_first and backend == "auto"
        return torch.ops.cspn_tpu_torch.cspn2d_tiled(g.contiguous(), b, s, steps, norm_type,
                                                     cspn_cuda._io_dtype(io_dtype))

    monkeypatch.setattr(unet, "cspn2d", via_op)
    model = _bf16_model(io_dtype="bfloat16").eval()
    program = export.export_serving(model, 32, 48, batch=2)
    node, paths = _cspn_input_producers(program)
    assert node.args[5] == BF16 and node.args[2].meta["val"].dtype == torch.float32
    for path in paths:
        assert [n.meta["val"].dtype for n in path] == [BF16] * len(path)
        assert "to_copy" not in str(path[-1].target) and "aten.to." not in str(path[-1].target)
    x = _rgbd(4)
    with torch.no_grad():
        assert torch.equal(program.module()(x), model(x))
    _promoting(monkeypatch)
    _, twin_paths = _cspn_input_producers(export.export_serving(model, 32, 48, batch=2))
    assert all(path[-1].meta["val"].dtype == torch.float32 for path in twin_paths)


def test_round_io_stays_the_plain_versions():
    """`_round_io` rounds through bf16 and back for the plain version; bf16
    inputs come back as their float32 upcast."""
    g, b, s = _inputs(7, 1, 4, 5)
    got = _round_io(_t(g, BF16), _t(b), _t(s), BF16)
    assert all(t.dtype == torch.float32 for t in got)
    assert torch.equal(got[0], _t(g, BF16).float())
    assert torch.equal(got[1], _t(b).to(BF16).float())
