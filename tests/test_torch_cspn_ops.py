"""The port's CSPN ops (cspn_tpu_torch/ops) against the JAX package's.

Same inputs, made with numpy from a seed, go through the JAX function and
its port counterpart on the CPU.  The plain PyTorch `cspn2d_reference` is
the CUDA kernel's plain version; it is held here against the JAX oracle
(`cspn_ref.cspn2d_reference`) and against the TPU kernel itself
(`cspn2d_pallas` in interpret mode, as tests/test_cspn_pallas.py runs it).
The CUDA kernel is held against the plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).

Tolerance: rtol 1e-5, atol 1e-5 in f32 (the two frameworks sum the eight
gate terms in different orders).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cspn_tpu.ops import cspn as jcspn
from cspn_tpu.ops import cspn_ref as jref
from cspn_tpu.ops import neighbors as jnb
from cspn_tpu.ops.cspn_pallas import cspn2d_pallas
from cspn_tpu_torch import resolve_device
from cspn_tpu_torch.ops import _build, cspn_cuda, cspn_ref, neighbors
from cspn_tpu_torch.ops.cspn import _round_io, cspn2d

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _inputs(seed, n, h, w, with_sparse=True):
    rng = np.random.default_rng(seed)
    guidance = rng.standard_normal((n, h, w, 8), dtype=np.float32)
    blur = rng.standard_normal((n, h, w), dtype=np.float32)
    sparse = None
    if with_sparse:
        sparse = (rng.random((n, h, w)) < 0.05).astype(np.float32) * np.abs(
            rng.standard_normal((n, h, w))
        ).astype(np.float32)
    return guidance, blur, sparse


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [1, 8, 24])
@pytest.mark.parametrize("shape", [(2, 13, 17), (2, 24, 40)])
def test_reference_matches_jax_reference(shape, steps, with_sparse, norm_type):
    g, b, s = _inputs(0, *shape, with_sparse)
    want = jref.cspn2d_reference(_j(g), _j(b), _j(s), steps=steps, norm_type=norm_type)
    got = cspn_ref.cspn2d_reference(_t(g), _t(b), _t(s), steps=steps, norm_type=norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
def test_all_zero_gates_guarded_to_zero(norm_type):
    # pixel (6, 6) of image 0 gathers only zero guidance: 0/0 must give
    # zero gates (center 1), not NaN; a negative sparse value gives
    # mask = sign = -1, keep = 2, as in the JAX package
    g, b, s = _inputs(1, 2, 13, 17)
    g[0, 4:9, 4:9, :] = 0.0
    s[1, 3, 3] = -1.5
    gates, center = cspn_ref.normalize_affinity_2d(_t(g), norm_type)
    assert torch.all(gates[0, 6, 6] == 0) and center[0, 6, 6] == 1.0
    want = jref.cspn2d_reference(_j(g), _j(b), _j(s), steps=24, norm_type=norm_type)
    got = cspn_ref.cspn2d_reference(_t(g), _t(b), _t(s), steps=24, norm_type=norm_type)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
def test_normalize_affinity_matches_jax(norm_type):
    g, _, _ = _inputs(2, 2, 13, 17)
    gj, cj = jref.normalize_affinity_2d(_j(g), norm_type)
    gt, ct = cspn_ref.normalize_affinity_2d(_t(g), norm_type)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-6)


def test_neighbors_match_jax():
    assert neighbors.OFFSETS_2D_REFERENCE == jnb.OFFSETS_2D_REFERENCE
    for ndim in (2, 3):
        assert neighbors.neighbor_offsets(ndim) == jnb.neighbor_offsets(ndim)
    x = np.random.default_rng(3).standard_normal((2, 5, 6, 7)).astype(np.float32)
    for offset, axes in [((1, -1), (-2, -1)), ((-2, 0), (1, 2)), ((0, 3, -1), (1, 2, 3)), ((5,), (1,))]:
        np.testing.assert_array_equal(
            neighbors.shift(_t(x), offset, axes).numpy(), np.asarray(jnb.shift(_j(x), offset, axes))
        )


@pytest.mark.parametrize(
    "norm_type, steps, with_sparse",
    [("8sum", 1, True), ("8sum", 24, True), ("8sum_abs", 24, True), ("8sum", 8, False)],
)
def test_reference_matches_tpu_kernel_interpret(norm_type, steps, with_sparse):
    g, b, s = _inputs(4, 2, 13, 17, with_sparse)
    want = cspn2d_pallas(_j(g), _j(b), _j(s), steps=steps, norm_type=norm_type, interpret=True)
    got = cspn_ref.cspn2d_reference(_t(g), _t(b), _t(s), steps=steps, norm_type=norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_round_io_bf16_matches_jax():
    g, b, s = _inputs(5, 2, 13, 17)
    want = jcspn._round_io(_j(g), _j(b), _j(s), jnp.bfloat16)
    got = _round_io(_t(g), _t(b), _t(s), torch.bfloat16)
    for w, t in zip(want, got):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert _round_io(_t(g), _t(b), None, "bfloat16")[2] is None
    assert _round_io(_t(g), _t(b), _t(s), None)[0] is not None


def test_cspn2d_dispatch_matches_jax_with_bf16_io():
    g, b, s = _inputs(6, 2, 13, 17)
    want = jcspn.cspn2d(_j(g), _j(b), _j(s), steps=8, backend="reference", io_dtype=jnp.bfloat16)
    for backend in ("auto", "reference"):
        got = cspn2d(_t(g), _t(b), _t(s), steps=8, backend=backend, io_dtype="bfloat16")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # channel-first guidance and the kernel wrapper's CPU path: same function
    got_cf = cspn2d(_t(g).permute(0, 3, 1, 2), _t(b), _t(s), steps=8, io_dtype="bfloat16",
                    channel_first=True)
    np.testing.assert_allclose(got_cf.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_kernel_wrapper_uses_plain_version_on_cpu():
    g, b, s = _inputs(7, 2, 13, 17)
    before = cspn_cuda.launches
    got = cspn_cuda.cspn2d_cuda(_t(g), _t(b), _t(s), steps=8, norm_type="8sum_abs")
    want = cspn_ref.cspn2d_reference(_t(g), _t(b), _t(s), steps=8, norm_type="8sum_abs")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cspn_cuda.launches == before  # the plain version is no kernel launch


def test_dispatch_errors():
    g, b, s = (_t(a) for a in _inputs(8, 1, 5, 6))
    with pytest.raises(ValueError, match="backend='kernel' needs CUDA"):
        cspn2d(g, b, s, backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        cspn2d(g, b, s, backend="pallas")
    with pytest.raises(ValueError, match="unknown norm_type"):
        cspn2d(g, b, s, norm_type="8max")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cspn_cuda._check_inputs(g.permute(0, 3, 1, 2).contiguous(), b, s, "8sum")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_targets_hopper_and_tracks_the_source(monkeypatch):
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    for name, (src, fns) in _build.KERNELS.items():
        text = (_build.CSRC / src).read_text()
        for fn, argtypes in fns.items():  # the ctypes signature matches the C one
            decl = text[text.index(f'extern "C" int {fn}('):]
            assert decl[: decl.index(")")].count(",") + 1 == len(argtypes)
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
        assert _build.library_path(name) != path  # the flags are in the hash
        monkeypatch.undo()
