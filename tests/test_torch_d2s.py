"""The port's depth-to-space (cspn_tpu_torch/ops/d2s.py) against the JAX package's.

`depth_to_space2_ref` (NCHW) is held bit for bit against
`cspn_tpu.ops.d2s_pallas.depth_to_space2_jnp` and the TPU kernel's custom
VJP `_d2s` in interpret mode (NHWC, as tests/test_d2s_pallas.py runs it),
through an NHWC <-> NCHW transpose: forward, gradient, and the plain
adjoint `space_to_depth2_ref`.  A permutation is exact, so every
comparison is equality.  float64 runs under `jax.enable_x64` against the
jnp form (the interpret-mode kernel's permutation matmuls accumulate in
float32).  Inputs are made with numpy from a seed.

The phase-list form (the four phase convs' outputs, as the decoder hands
them over) is held, output and its four gradients, against JAX's
`depth_to_space2` of `jnp.concatenate(phases, -1)` and its `jax.vjp`, at
small cuts of the b8 decoder's five stages (N = 2, narrow C) and two odd
crops, at float32, bf16 and float64.  The subpixel decoder's conv and the
int8 subpixel conv concatenate nothing before depth-to-space.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.ops import d2s_pallas
from cspn_tpu_torch.models import decoder
from cspn_tpu_torch.ops import _build, d2s
from cspn_tpu_torch.utils import quant

torch.set_num_threads(1)

CASES = [
    # (n, h, w, C, oh, ow): even and odd crops in each axis
    (2, 5, 7, 1, 9, 13),
    (1, 4, 6, 1, 8, 12),
    (2, 3, 5, 9, 6, 9),
    (2, 4, 5, 9, 7, 10),
    (1, 4, 4, 64, 7, 7),
    (2, 3, 4, 64, 6, 8),
]


def _to_nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(case, seed):
    n, h, w, c, oh, ow = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, 4 * c)).astype(np.float32),
            rng.standard_normal((n, oh, ow, c)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    x, _ = _inputs(case, 0)
    oh, ow = case[4:]
    want = np.asarray(d2s_pallas.depth_to_space2_jnp(jnp.asarray(x), oh, ow))
    np.testing.assert_array_equal(np.asarray(d2s_pallas._d2s(jnp.asarray(x), oh, ow, True)), want)
    got = d2s.depth_to_space2_ref(_to_nchw(x), oh, ow)
    assert got.shape == (case[0], case[3], oh, ow)
    np.testing.assert_array_equal(_to_nhwc(got), want)
    np.testing.assert_array_equal(_to_nhwc(d2s.depth_to_space2(_to_nchw(x), oh, ow)), want)


@pytest.mark.parametrize("case", CASES)
def test_gradient_matches_jax(case):
    x, t = _inputs(case, 1)
    oh, ow = case[4:]
    want = np.asarray(jax.grad(lambda v: jnp.vdot(d2s_pallas._d2s(v, oh, ow, True), t))(jnp.asarray(x)))
    np.testing.assert_array_equal(
        np.asarray(jax.grad(lambda v: jnp.vdot(d2s_pallas.depth_to_space2_jnp(v, oh, ow), t))(
            jnp.asarray(x))), want)
    xt = _to_nchw(x).requires_grad_(True)
    ct = _to_nchw(t)
    (got,) = torch.autograd.grad(d2s.depth_to_space2(xt, oh, ow), xt, ct)
    np.testing.assert_array_equal(_to_nhwc(got), want)
    np.testing.assert_array_equal(_to_nhwc(d2s.space_to_depth2_ref(ct, *case[1:3])), want)


def test_bfloat16_matches_jax():
    case = (2, 4, 5, 9, 7, 10)
    x, t = _inputs(case, 2)
    oh, ow = case[4:]
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(d2s_pallas._d2s(xj, oh, ow, True), np.float32)
    np.testing.assert_array_equal(np.asarray(d2s_pallas.depth_to_space2_jnp(xj, oh, ow), np.float32), want)
    xt = _to_nchw(x).to(torch.bfloat16).requires_grad_(True)
    got = d2s.depth_to_space2(xt, oh, ow)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_to_nhwc(got.float()), want)

    def loss(v):
        return jnp.vdot(d2s_pallas._d2s(v, oh, ow, True).astype(jnp.float32), t)

    gj = np.asarray(jax.grad(loss)(xj), np.float32)
    (gt,) = torch.autograd.grad(got, xt, _to_nchw(t).to(torch.bfloat16))
    np.testing.assert_array_equal(_to_nhwc(gt.float()), gj)


def test_float64_matches_jax():
    case = (2, 5, 7, 1, 9, 13)
    x, t = (a.astype(np.float64) for a in _inputs(case, 3))
    oh, ow = case[4:]
    with jax.enable_x64(True):
        xj = jnp.asarray(x)
        want = np.asarray(d2s_pallas.depth_to_space2_jnp(xj, oh, ow))
        gj = np.asarray(jax.grad(lambda v: jnp.vdot(d2s_pallas.depth_to_space2_jnp(v, oh, ow), t))(xj))
    assert want.dtype == gj.dtype == np.float64
    xt = _to_nchw(x).requires_grad_(True)
    got = d2s.depth_to_space2(xt, oh, ow)
    (gt,) = torch.autograd.grad(got, xt, _to_nchw(t))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(_to_nhwc(got), want)
    np.testing.assert_array_equal(_to_nhwc(gt), gj)


@pytest.mark.parametrize("shape, crop", [
    ((1, 6, 8, 30), (11, 15)),  # channels not a multiple of 4
    ((1, 6, 8, 64), (13, 15)),  # crop past 2x
    ((1, 6, 8, 64), (11, 0)),  # empty crop
])
def test_argument_errors_match_jax(shape, crop):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as want:
        d2s_pallas.depth_to_space2(jnp.asarray(x), *crop)
    with pytest.raises(ValueError) as got:
        d2s.depth_to_space2(_to_nchw(x), *crop)
    assert str(got.value) == str(want.value)


def test_backend_errors():
    x = torch.zeros(1, 8, 3, 4)
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        d2s.depth_to_space2(x, 6, 8, backend="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        d2s.depth_to_space2(x, 6, 8, backend="kernel")
    with pytest.raises(ValueError, match=r"\[N, 4C, H, W\]"):
        d2s.depth_to_space2(x[0], 6, 8)
    np.testing.assert_array_equal(d2s.depth_to_space2(x, 6, 8, backend="reference").numpy(),
                                  d2s.depth_to_space2_ref(x, 6, 8).numpy())


def test_auto_on_cpu_runs_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU tensor reached the {name} kernel")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(d2s, "launches", 0)
    monkeypatch.setattr(d2s, "bwd_launches", 0)
    x, t = _inputs(CASES[0], 4)
    xt = _to_nchw(x).requires_grad_(True)
    out = d2s.depth_to_space2(xt, *CASES[0][4:])
    out.backward(_to_nchw(t))
    assert torch.equal(out, d2s.depth_to_space2_ref(xt, *CASES[0][4:]))
    assert (d2s.launches, d2s.bwd_launches) == (0, 0)


# (n, h, w, C, oh, ow): the b8 nyu_eval decoder's five stages (layer1-4, the
# fused head: chip_smoke.py's D2S_STAGES) at N = 2 and narrow C, an odd crop
# in both axes at C = 1, and a crop of several rows and columns
PHASE_CASES = {
    "layer1": (2, 8, 10, 4, 15, 19),
    "layer2": (2, 15, 19, 3, 29, 38),
    "layer3": (2, 29, 38, 2, 57, 76),
    "layer4": (2, 57, 76, 2, 114, 152),
    "head": (2, 114, 152, 1, 228, 304),
    "odd": (2, 5, 7, 1, 9, 13),
    "deep crop": (2, 6, 7, 2, 9, 10),
}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float64": (torch.float64, jnp.float64)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stage", list(PHASE_CASES))
def test_phase_list_matches_jax(stage, dtype):
    """depth_to_space2 of the four phases [N, C, H, W] (px-major) and its
    four gradients against JAX's depth_to_space2 of the phases
    concatenated on the channel axis, and its vjp, bit for bit."""
    n, h, w, c, oh, ow = PHASE_CASES[stage]
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(len(stage) * 7 + len(dtype))
    # values of the dtype, exactly the same on both sides
    phases = [torch.from_numpy(rng.standard_normal((n, c, h, w))).to(tdt) for _ in range(4)]
    ct = torch.from_numpy(rng.standard_normal((n, c, oh, ow))).to(tdt)
    with jax.enable_x64(dtype == "float64"):
        pj = [jnp.asarray(_to_nhwc(p.double()), jdt) for p in phases]
        want, vjp = jax.vjp(lambda *ps: d2s_pallas.depth_to_space2(jnp.concatenate(ps, -1), oh, ow),
                            *pj)
        gwant = vjp(jnp.asarray(_to_nhwc(ct.double()), jdt))
        want, gwant = (np.asarray(a, np.float64) for a in (want, np.stack(gwant)))
    pt = [p.clone().requires_grad_(True) for p in phases]
    got = d2s.depth_to_space2(pt, oh, ow)
    assert got.shape == (n, c, oh, ow) and got.dtype == tdt
    grads = torch.autograd.grad(got, pt, ct)
    np.testing.assert_array_equal(_to_nhwc(got.double()), want)
    for k, g in enumerate(grads):
        assert g.shape == (n, c, h, w) and g.dtype == tdt
        np.testing.assert_array_equal(_to_nhwc(g.double()), gwant[k])
    # the same as the joined tensor's, forward and adjoint
    joined = torch.cat(phases, 1)
    assert torch.equal(got, d2s.depth_to_space2(joined, oh, ow))
    assert torch.equal(torch.cat(grads, 1), d2s.space_to_depth2_ref(ct, h, w))


def test_phase_list_argument_errors():
    p = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError, match="four phases, got 3 items"):
        d2s.depth_to_space2([p, p, p], 6, 8)
    with pytest.raises(ValueError, match="share shape, dtype and device"):
        d2s.depth_to_space2([p, p, p, p.double()], 6, 8)
    with pytest.raises(ValueError, match="share shape"):
        d2s.depth_to_space2([p, p, p, torch.zeros(1, 3, 3, 4)], 6, 8)
    with pytest.raises(ValueError, match=r"\[N, C, H, W\]"):
        d2s.depth_to_space2([p[0]] * 4, 6, 8)
    with pytest.raises(ValueError, match=r"crop \(7,8\) outside 2x of \(3, 4\)"):
        d2s.depth_to_space2([p] * 4, 7, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        d2s.depth_to_space2([p] * 4, 6, 8, backend="kernel")


def test_subpixel_convs_concatenate_nothing_before_depth_to_space(monkeypatch):
    """From 128 features the decoder's subpixel conv and the int8 subpixel
    conv hand depth_to_space2 the four phase convs' outputs as they are:
    no torch.cat in their modules' code (counted by a patched torch.cat
    that reads its caller's module).  The float32 output equals the plain
    unpool + conv's."""
    import sys

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 7)).astype(np.float32))
    conv = decoder.SubpixelUnpoolConv(6, 128, 5)
    torch.nn.init.normal_(conv.weight, generator=torch.Generator().manual_seed(3))
    qc = quant.QuantConv(conv, subpixel=True)
    handed, cats = [], []
    real_d2s, real_cat = d2s.depth_to_space2, torch.cat

    def spy(t, oh, ow):
        handed.append([tuple(p.shape) for p in t] if isinstance(t, (list, tuple)) else t.shape)
        return real_d2s(t, oh, ow)

    def cat(*args, **kwargs):
        cats.append(sys._getframe(1).f_globals.get("__name__"))
        return real_cat(*args, **kwargs)

    for module in (decoder, quant):
        monkeypatch.setattr(module, "depth_to_space2", spy)
    monkeypatch.setattr(torch, "cat", cat)
    with torch.no_grad():
        got, got_int8 = conv(x, 9, 13), qc(x, 9, 13)
    monkeypatch.undo()
    assert handed == [[(2, 128, 5, 7)] * 4] * 2
    assert not {decoder.__name__, quant.__name__} & set(cats), cats
    with torch.no_grad():
        want = torch.nn.functional.conv2d(decoder.unpool2x(x, 9, 13), conv.weight, padding=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert got_int8.shape == want.shape and torch.isfinite(got_int8).all()
