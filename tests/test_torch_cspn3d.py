"""The port's nd CSPN ops (ops/cspn_ref.py, ops/cspn.py:cspn_nd), the 3D
kernels' plain version (ops/cspn3d_cuda.py on the CPU) and the linear
resizes (ops/resize.py) against the JAX package.

Inputs come from numpy seeds and cross as numpy arrays.  Tolerances:
  - forward ops in float32 on both sides: rtol 1e-5, atol 1e-6 (the
    summation order of the 26-gate sums differs);
  - the plain 3D propagation and its autograd VJP against the TPU kernels
    `affinity_propagate3d_fused` / `affinity_propagate3d_fused_bwd` run in
    interpret mode with float32 gates: rtol 1e-5, atol 1e-5 (24 steps);
    the plain version of the bf16-gate route against them at bf16 gates:
    test_plain_bf16_gate_propagation_matches_the_tpu_kernels;
  - gradients against `jax.grad` of the reference: rtol 1e-4, atol 1e-6,
    away from exactly-zero guidance (ROADMAP.md Queue 3, trap 7:
    `jnp.abs`'(0) = 1, torch and the JAX custom VJP take sign(0) = 0);
  - resizes: rtol 1e-6, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.ops import cspn3d_pallas
from cspn_tpu.ops import cspn_ref as jref
from cspn_tpu.ops.resize import resize_bilinear as jresize_bilinear
from cspn_tpu.ops.resize import resize_trilinear as jresize_trilinear
from cspn_tpu_torch.ops import cspn3d_cuda, cspn_ref, resize
from cspn_tpu_torch.ops.cspn import BACKENDS, affinity_propagate, cspn_nd

torch.set_num_threads(1)

SPATIAL = {2: (7, 9), 3: (3, 5, 7)}


def _gates(rng, shape, n_gates):
    g = rng.random((*shape, n_gates)).astype(np.float32) + 0.05
    return g / g.sum(-1, keepdims=True)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("c", [1, 2])
def test_affinity_propagate_matches_jax(ndim, c):
    rng = np.random.default_rng(ndim * 10 + c)
    shape = (2, *SPATIAL[ndim])
    feat = rng.standard_normal((*shape, c)).astype(np.float32)
    gates = _gates(rng, shape, 3**ndim - 1)
    want = np.asarray(jref.affinity_propagate_reference(jnp.asarray(feat), jnp.asarray(gates)))
    got = cspn_ref.affinity_propagate_reference(torch.from_numpy(feat), torch.from_numpy(gates))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    also = affinity_propagate(torch.from_numpy(feat), torch.from_numpy(gates), backend="kernel")
    assert torch.equal(also, got)  # one step is plain PyTorch on every backend


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("c", [1, 2])
def test_cspn_nd_reference_matches_jax(ndim, c):
    rng = np.random.default_rng(100 + ndim * 10 + c)
    shape = (2, *SPATIAL[ndim])
    guide = rng.standard_normal((*shape, c * (3**ndim - 1))).astype(np.float32)
    guide[0, :2, :2] = 0.0  # all-zero gates: the 1e-12 guard, centre weight 1
    feat = rng.standard_normal((*shape, c)).astype(np.float32)
    want = np.asarray(jref.cspn_nd_reference(jnp.asarray(guide), jnp.asarray(feat), steps=5))
    got = cspn_ref.cspn_nd_reference(torch.from_numpy(guide), torch.from_numpy(feat), steps=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    for backend in ("auto", "reference"):  # on the CPU both run the reference
        out = cspn_nd(torch.from_numpy(guide), torch.from_numpy(feat), steps=5, backend=backend)
        assert torch.equal(out, got)
    cf = cspn_nd(torch.from_numpy(guide).movedim(-1, 1), torch.from_numpy(feat).movedim(-1, 1),
                 steps=5, channel_first=True)
    assert torch.equal(cf.movedim(1, -1), got)


def test_parity_helpers_match_jax():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((4, 5, 2)).astype(np.float32)
    for a, b in zip(cspn_ref.normalize_gate(torch.from_numpy(g)), jref.normalize_gate(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    es = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(8)]
    te, je = [torch.from_numpy(e) for e in es], [jnp.asarray(e) for e in es]
    np.testing.assert_array_equal(cspn_ref.max_of_4_tensor(*te[:4]).numpy(),
                                  np.asarray(jref.max_of_4_tensor(*je[:4])))
    np.testing.assert_array_equal(cspn_ref.max_of_8_tensor(*te).numpy(),
                                  np.asarray(jref.max_of_8_tensor(*je)))


# odd sizes: JAX pads H to 8 and W to 128 inside the kernels
@pytest.mark.parametrize("shape, steps", [((2, 3, 5, 7), 24), ((1, 4, 9, 13), 5), ((3, 1, 1, 1), 2)])
def test_plain_3d_propagation_matches_the_tpu_kernels(shape, steps):
    rng = np.random.default_rng(sum(shape) + steps)
    gates = _gates(rng, (shape[0], *shape[1:]), 26).transpose(0, 4, 1, 2, 3).copy()
    gates[0, :, :1, :2, :3] = 0.0  # zero gates: the centre weight is 1 there
    x0 = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(cspn3d_pallas.affinity_propagate3d_fused(
        jnp.asarray(x0), jnp.asarray(gates), steps=steps, interpret=True, gate_dtype=jnp.float32))
    want_w, want_x = cspn3d_pallas.affinity_propagate3d_fused_bwd(
        jnp.asarray(x0), jnp.asarray(gates), jnp.asarray(ct), steps=steps, interpret=True,
        gate_dtype=jnp.float32)

    g = torch.from_numpy(gates).requires_grad_(True)
    x = torch.from_numpy(x0).requires_grad_(True)
    before = (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches)
    got = cspn3d_cuda.propagate3d(g, x, steps=steps)  # CPU tensors: the plain version
    got_w, got_x = torch.autograd.grad(got, (g, x), torch.from_numpy(ct))
    assert (cspn3d_cuda.launches, cspn3d_cuda.bwd_launches) == before  # no kernel on the CPU
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape, steps", [((2, 3, 5, 7), 24), ((3, 1, 1, 1), 2)])
def test_plain_bf16_gate_propagation_matches_the_tpu_kernels(shape, steps):
    """The plain version of the kernels' bf16-gate route (gate_dtype
    bfloat16: the float32 sweep on the gates rounded to bf16) against the
    TPU kernels at their default bf16 gates, in interpret mode.  Forward:
    the same function (rtol 1e-5, atol 1e-6; it differs from the float32
    route by ~1e-4).  Backward: the exact adjoint at the rounded gates, so
    JAX's backward given the rounded gates at float32 (rtol 1e-5, atol
    1e-5, 24 steps); against JAX's backward at bf16, whose centre weight
    1 - sum_d w_d it takes from the unrounded gates (cspn3d_pallas.py:484)
    where its forward and the port take it from the rounded ones, 1e-2 of
    the largest cotangent (measured 5.5e-3 where every gate of the
    1-voxel volume falls outside it)."""
    rng = np.random.default_rng(sum(shape) + steps)
    gates = _gates(rng, (shape[0], *shape[1:]), 26).transpose(0, 4, 1, 2, 3).copy()
    gates[0, :, :1, :2, :3] = 0.0
    rounded = np.asarray(jnp.asarray(gates, jnp.bfloat16).astype(jnp.float32))
    x0 = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(cspn3d_pallas.affinity_propagate3d_fused(
        jnp.asarray(x0), jnp.asarray(gates), steps=steps, interpret=True))
    g = torch.from_numpy(gates).requires_grad_(True)
    x = torch.from_numpy(x0).requires_grad_(True)
    got = cspn3d_cuda.propagate3d(g, x, steps=steps, gate_dtype=torch.bfloat16)
    got_w, got_x = torch.autograd.grad(got, (g, x), torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    exact_w, exact_x = cspn3d_pallas.affinity_propagate3d_fused_bwd(
        jnp.asarray(x0), jnp.asarray(rounded), jnp.asarray(ct), steps=steps, interpret=True,
        gate_dtype=jnp.float32)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(exact_w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(exact_x), rtol=1e-5, atol=1e-5)
    bf16_w, bf16_x = cspn3d_pallas.affinity_propagate3d_fused_bwd(
        jnp.asarray(x0), jnp.asarray(gates), jnp.asarray(ct), steps=steps, interpret=True)
    for a, b in ((got_w, bf16_w), (got_x, bf16_x)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-2 * np.abs(b).max())
    # the float32 route is another function; the CPU's cspn_nd stays it
    f32 = cspn3d_cuda.propagate3d(torch.from_numpy(gates), torch.from_numpy(x0), steps=steps)
    assert not torch.equal(f32, got.detach()) or steps < 3
    assert torch.equal(cspn3d_cuda.round_gates(g, torch.float32), g)
    with pytest.raises(ValueError, match="gate_dtype"):
        cspn3d_cuda.propagate3d(g, x, steps=steps, gate_dtype=torch.float16)


def test_cspn_nd_gate_dtype_picks_the_route():
    """cspn_nd on the CPU: the exact float32 reference by default (JAX's
    reference backend); gate_dtype bfloat16 the plain version of the
    kernels' bf16 route, in either layout; the 2D op refuses bf16 gates."""
    rng = np.random.default_rng(11)
    guide = torch.from_numpy(rng.standard_normal((2, 3, 5, 7, 26)).astype(np.float32))
    feat = torch.from_numpy(rng.standard_normal((2, 3, 5, 7, 1)).astype(np.float32))
    exact = cspn_ref.cspn_nd_reference(guide, feat, steps=4)
    assert torch.equal(cspn_nd(guide, feat, steps=4), exact)
    bf16 = cspn_nd(guide, feat, steps=4, gate_dtype=torch.bfloat16)
    assert torch.equal(bf16, cspn3d_cuda.cspn3d_reference(guide, feat, steps=4,
                                                          gate_dtype=torch.bfloat16))
    assert torch.equal(bf16, cspn3d_cuda.cspn3d_cuda(guide, feat, steps=4,
                                                     gate_dtype=torch.bfloat16))
    cf = cspn_nd(guide.movedim(-1, 1), feat.movedim(-1, 1), steps=4, gate_dtype=torch.bfloat16,
                 channel_first=True)
    assert torch.equal(cf.movedim(1, -1), bf16)
    assert 0 < (bf16 - exact).abs().max() < 1e-2 * exact.abs().max()
    with pytest.raises(ValueError, match="float32 gates"):
        cspn_nd(guide[:, 0, ..., :8], feat[:, 0], steps=4, gate_dtype=torch.bfloat16)


@pytest.mark.parametrize("ndim, c", [(2, 2), (3, 1), (3, 2)])
def test_cspn_nd_gradients_match_jax_grad(ndim, c):
    rng = np.random.default_rng(7 + ndim + c)
    shape = (2, *SPATIAL[ndim])
    # guidance bounded away from 0 (trap 7), random signs
    guide = (0.1 + rng.random((*shape, c * (3**ndim - 1)))) * rng.choice([-1.0, 1.0], (
        *shape, c * (3**ndim - 1)))
    feat = rng.standard_normal((*shape, c))
    ct = rng.standard_normal((*shape, c))
    with jax.enable_x64(True):
        def loss(gd, ft):
            return jnp.sum(jref.cspn_nd_reference(gd, ft, steps=4) * ct)

        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(guide), jnp.asarray(feat))
    g = torch.from_numpy(guide).requires_grad_(True)
    f = torch.from_numpy(feat).requires_grad_(True)
    got = torch.autograd.grad((cspn_nd(g, f, steps=4) * torch.from_numpy(ct)).sum(), (g, f))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    # the kernel wrapper's CPU path (normalization + plain propagation)
    g2 = torch.from_numpy(guide).requires_grad_(True)
    if ndim == 3:
        out = cspn3d_cuda.cspn3d_cuda(g2, f.detach(), steps=4)
        (d_g,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (g2,))
        np.testing.assert_allclose(d_g.numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-6)


def test_cspn_nd_rejects_bad_arguments():
    guide, feat = torch.zeros(1, 3, 5, 7, 26), torch.zeros(1, 3, 5, 7, 1)
    with pytest.raises(ValueError, match="unknown backend"):
        cspn_nd(guide, feat, backend="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cspn_nd(guide, feat, backend="kernel")
    with pytest.raises(ValueError, match="C\\*\\(k\\^n-1\\)"):
        cspn_nd(guide[..., :25], feat)
    with pytest.raises(ValueError, match="C\\*26"):
        cspn3d_cuda.cspn3d_cuda(guide[..., :25], feat)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cspn3d_cuda._check_inputs(torch.zeros(1, 26, 3, 5, 7), torch.zeros(1, 3, 5, 7))
    assert BACKENDS == ("auto", "kernel", "reference")


# every upsampling ratio of the stereo model: the Hourglass3D halves, odd
# ones included ((d-1)//2+1: 3 -> 2 -> 1 and back), and D/4 -> D, H/4 -> H,
# W/4 -> W of the disparity regression
@pytest.mark.parametrize("src, dst", [
    ((1, 1, 1), (2, 2, 3)), ((2, 2, 3), (3, 4, 6)), ((2, 3, 3), (3, 5, 5)),
    ((12, 16, 32), (24, 32, 64)), ((6, 8, 16), (12, 16, 32)), ((3, 2, 3), (12, 8, 12)),
    ((48, 8, 16), (192, 32, 64)), ((4, 8, 12), (16, 32, 48)),
])
def test_resize_trilinear_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(jresize_trilinear(jnp.asarray(x), dst))
    got = resize.resize_trilinear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    cf = resize.resize_trilinear(torch.from_numpy(x).movedim(-1, 1), dst, channel_first=True)
    assert torch.equal(cf.movedim(1, -1), got)


@pytest.mark.parametrize("src, dst", [((3, 5), (6, 10)), ((8, 16), (32, 64)), ((3, 3), (5, 5))])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    x = rng.standard_normal((2, *src, 4)).astype(np.float32)
    want = np.asarray(jresize_bilinear(jnp.asarray(x), dst))
    got = resize.resize_bilinear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_resize_refuses_downsampling():
    with pytest.raises(ValueError, match="downsampling"):
        resize.resize_trilinear(torch.zeros(1, 4, 4, 4, 1), (2, 4, 4))


def test_kernel_kinds_name_the_3d_kernels_first():
    """The 3D kernels' profiler names are classified as 3D before the 2D
    kinds' substrings are tried: the forward's sweep as the forward, the
    reverse sweep (every instantiation) and the gate pass as the backward."""
    from cspn_tpu_torch.utils import profiling

    kinds = [profiling._kind(k) for k in (
        "void (anonymous namespace)::cspn3d_fwd_sweep_kernel<8>(float const*, float const*, float*, float*, float*, int, int, int, int, int, int, int)",
        "void (anonymous namespace)::cspn3d_adj_sweep_kernel<8>(float const*, float const*, float*, float*, float*, int, int, int, int, int, int, int)",
        "void (anonymous namespace)::cspn3d_adj_sweep_kernel<16>(float const*, float const*, float*, float*, float*, int, int, int, int, int, int, int)",
        "void (anonymous namespace)::cspn3d_gate_grad_kernel(float const*, float const*, float const*, float const*, float*, int, int, int, int, int)",
        "void (anonymous namespace)::cspn2d_fwd_kernel<false>((anonymous namespace)::MarchArgs)",
        "void (anonymous namespace)::reverse_tile_kernel(float const*, float const*, int, int)",
    )]
    assert kinds == ["cspn3d_fwd"] + ["cspn3d_bwd"] * 3 + ["cspn2d_fwd", "cspn2d_bwd"]
