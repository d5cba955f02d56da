"""The spatially sharded CSPN (cspn_tpu_torch/parallel/) against the JAX
package's (cspn_tpu/parallel/halo.py) on the 8-device CPU mesh of
tests/conftest.py, and against the port's unsharded ops and models.

The port runs its in-process mesh (the S row blocks stacked along the
batch in one process).  JAX runs shard_map over `make_mesh(data=1,
spatial=S)`, with its composed segments (fused=False: its fused and
composed forms are held equal by tests/test_parallel.py) except in one
case that runs its Pallas segment in interpret mode.  Inputs come from
numpy seeds; the port runs float64 and JAX float32, so the tolerances are
JAX's rounding, as tests/test_parallel.py's: rtol/atol 1e-5 forward, rtol
1e-4 atol 1e-5 for gradients.  Against the port's own unsharded ops both
sides are float64 and agree to 1e-10.  Whole models are compared sharded
against unsharded in float64 on the port's side only (ROADMAP.md Queue 3,
trap 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.parallel import cspn2d_spatial as j_cspn2d_spatial
from cspn_tpu.parallel import cspn_nd_spatial as j_cspn_nd_spatial
from cspn_tpu.parallel import halo as j_halo
from cspn_tpu.parallel import hlo_checks
from cspn_tpu.parallel import make_mesh as j_make_mesh
from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn import cspn2d, cspn_nd
from cspn_tpu_torch.parallel import cspn2d_spatial, cspn_nd_spatial, exchange_counts, halo, make_mesh

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(scope="module")
def jmesh():
    return {s: j_make_mesh(data=1, spatial=s) for s in (2, 4)}


def _inputs(seed=0, n=2, h=16, w=20):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, h, w, 8), dtype=np.float32)
    b = rng.standard_normal((n, h, w), dtype=np.float32)
    s = ((rng.random((n, h, w)) < 0.05) * np.abs(rng.standard_normal((n, h, w)))).astype(np.float32)
    return g, b, s


def _t(*arrays):
    return [None if a is None else torch.tensor(a, dtype=F64) for a in arrays]


@pytest.mark.parametrize("halo_k", [1, 2, 4])
@pytest.mark.parametrize("spatial", [2, 4])
def test_cspn2d_spatial_matches_jax_and_unsharded(jmesh, spatial, halo_k):
    g, b, s = _inputs()
    steps = 7
    want = jax.jit(lambda g, b, s: j_cspn2d_spatial(
        g, b, s, mesh=jmesh[spatial], steps=steps, halo=halo_k, fused=False))(g, b, s)
    tg, tb, ts = _t(g, b, s)
    got = cspn2d_spatial(tg, tb, ts, mesh=make_mesh(spatial=spatial), steps=steps, halo=halo_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    unsharded = cspn2d(tg, tb, ts, steps=steps)
    torch.testing.assert_close(got, unsharded, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("norm_type, with_sparse", [("8sum_abs", True), ("8sum", False)])
def test_cspn2d_spatial_norms_and_no_sparse(jmesh, norm_type, with_sparse):
    g, b, s = _inputs(1)
    s = s if with_sparse else None
    want = jax.jit(lambda g, b: j_cspn2d_spatial(
        g, b, s, mesh=jmesh[4], steps=6, norm_type=norm_type, halo=2, fused=False))(g, b)
    tg, tb, ts = _t(g, b, s)
    got = cspn2d_spatial(tg, tb, ts, mesh=make_mesh(spatial=4), steps=6, norm_type=norm_type,
                         halo=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, cspn2d(tg, tb, ts, steps=6, norm_type=norm_type),
                               rtol=1e-10, atol=1e-10)


def test_cspn2d_spatial_matches_jax_fused_segments(jmesh):
    """Against JAX's Pallas segment (interpret mode); the port's segment
    (cspn2d_halo_segment on the CPU) and its composed form agree too."""
    g, b, s = _inputs(2)
    want = jax.jit(lambda g, b, s: j_cspn2d_spatial(
        g, b, s, mesh=jmesh[2], steps=9, halo=3))(g, b, s)
    tg, tb, ts = _t(g, b, s)
    mesh = make_mesh(spatial=2)
    got = cspn2d_spatial(tg, tb, ts, mesh=mesh, steps=9, halo=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    composed = cspn2d_spatial(tg, tb, ts, mesh=mesh, steps=9, halo=3, fused=False)
    torch.testing.assert_close(got, composed, rtol=1e-12, atol=1e-12)


def test_cspn2d_spatial_channel_first_and_one_block():
    g, b, s = _t(*_inputs(3))
    want = cspn2d(g, b, s, steps=5)
    got = cspn2d_spatial(g.movedim(-1, 1), b, s, mesh=make_mesh(spatial=2), steps=5, halo=2,
                         channel_first=True)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    halo.exchanges = 0
    one = cspn2d_spatial(g, b, s, mesh=make_mesh(spatial=1), steps=5, halo=2)
    torch.testing.assert_close(one, want, rtol=1e-10, atol=1e-10)
    assert halo.exchanges == 0  # one block pads, as JAX's size-1 axis does


@pytest.mark.parametrize("spatial, halo_k, with_sparse", [(2, None, True), (4, 3, False)])
def test_first_segment_inputs_are_what_the_path_runs(spatial, halo_k, with_sparse):
    """The segment check's inputs: the S blocks stacked along the batch,
    each K-extended; one segment of K steps on them is cspn2d_spatial's."""
    g, b, s = _t(*_inputs(4))
    s = s if with_sparse else None
    mesh, steps = make_mesh(spatial=spatial), 3
    gates, base, keep, x0, k = halo.first_segment_inputs(
        g.movedim(-1, 1), b, s, mesh=mesh, steps=steps, halo=halo_k, channel_first=True)
    assert k == halo.effective_halo(halo_k, steps, 16 // spatial, 20, 2)
    assert gates.shape == (spatial * 2, 8, 16 // spatial + 2 * k, 20)
    assert (keep is None) == (s is None)
    assert k >= steps  # one segment: the interior of its result is the output
    out = mesh.join_rows(cspn_ref.halo_segment_reference(gates, base, keep, x0, steps)[:, k:-k])
    want = cspn2d_spatial(g, b, s, mesh=mesh, steps=steps, halo=halo_k)
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("spatial, halo_k, with_sparse", [(2, 2, True), (4, 1, False)])
def test_cspn2d_spatial_grads_match(jmesh, spatial, halo_k, with_sparse):
    g, b, s = _inputs(4, n=2, h=8, w=10)
    s = s if with_sparse else None

    def loss(g, b):
        return jnp.sum(j_cspn2d_spatial(g, b, s, mesh=jmesh[spatial], steps=4, halo=halo_k,
                                        fused=False) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(g, b)
    tg, tb, ts = _t(g, b, s)
    tg.requires_grad_(True)
    tb.requires_grad_(True)
    out = cspn2d_spatial(tg, tb, ts, mesh=make_mesh(spatial=spatial), steps=4, halo=halo_k)
    got = torch.autograd.grad((out**2).sum(), (tg, tb))
    unsharded = torch.autograd.grad((cspn2d(tg, tb, ts, steps=4) ** 2).sum(), (tg, tb))
    for a, e, u in zip(got, want, unsharded):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(a, u, rtol=1e-10, atol=1e-10)


def _volume(seed, shape, gates):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (gates,), dtype=np.float32),
            rng.standard_normal(shape + (1,), dtype=np.float32))


@pytest.mark.parametrize("spatial, halo_k, steps", [(4, 1, 4), (2, 3, 8)])
def test_cspn_nd_spatial_3d_matches_jax(jmesh, spatial, halo_k, steps):
    """The 3D segments: the port's fused path (propagate3d, its plain
    version on the CPU) and composed path against JAX's; D = 8."""
    guide, feat = _volume(7, (2, 8, 6, 10), 26)
    want = jax.jit(lambda g, f: j_cspn_nd_spatial(
        g, f, mesh=jmesh[spatial], steps=steps, halo=halo_k, fused=False))(guide, feat)
    tg, tf = _t(guide, feat)
    for fused in (True, False):
        got = cspn_nd_spatial(tg, tf, mesh=make_mesh(spatial=spatial), steps=steps,
                              halo=halo_k, fused=fused)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, cspn_nd(tg, tf, steps=steps), rtol=1e-10, atol=1e-10)


def test_cspn_nd_spatial_3d_grads_match(jmesh):
    guide, feat = _volume(3, (2, 8, 4, 6), 26)

    def loss(g, f):
        return jnp.sum(j_cspn_nd_spatial(g, f, mesh=jmesh[2], steps=4, halo=2, fused=False) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(guide, feat)
    tg, tf = (t.requires_grad_(True) for t in _t(guide, feat))
    out = cspn_nd_spatial(tg, tf, mesh=make_mesh(spatial=2), steps=4, halo=2)
    got = torch.autograd.grad((out**2).sum(), (tg, tf))
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4, atol=1e-5)


def test_cspn_nd_spatial_2d_paddle_matches_jax(jmesh):
    """The nd path on 2D paddle-semantics maps (C = 2): composed stencil."""
    rng = np.random.default_rng(11)
    guide = rng.standard_normal((2, 16, 12, 16), dtype=np.float32)
    feat = rng.standard_normal((2, 16, 12, 2), dtype=np.float32)
    want = jax.jit(lambda g, f: j_cspn_nd_spatial(
        g, f, mesh=jmesh[4], steps=6, halo=2, fused=False))(guide, feat)
    tg, tf = _t(guide, feat)
    got = cspn_nd_spatial(tg, tf, mesh=make_mesh(spatial=4), steps=6, halo=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got_cf = cspn_nd_spatial(tg.movedim(-1, 1), tf.movedim(-1, 1), mesh=make_mesh(spatial=4),
                             steps=6, halo=2, channel_first=True)
    torch.testing.assert_close(got_cf.movedim(1, -1), got)


# the JAX package's v5e constants, passed to the port's model as parameters
_V5E = dict(hbm_bps=j_halo._HBM_BPS, seg_fixed_s=j_halo._SEG_LAUNCH_S, link_bps=j_halo._ICI_BPS,
            link_lat_s=j_halo._ICI_LAT_S)


@pytest.mark.parametrize("steps, extent, plane_px, batch, n_gates, t_step", [
    (24, 176, 1216, 4, 8, j_halo._T2D_STEP_S_PER_PX),
    (24, 88, 1216, 1, 8, j_halo._T2D_STEP_S_PER_PX),
    (24, 114, 304, 8, 8, j_halo._T2D_STEP_S_PER_PX),
    (12, 4, 20, 2, 8, j_halo._T2D_STEP_S_PER_PX),
    (24, 24, 64 * 128, 4, 26, j_halo._T3D_STEP_S_PER_VOX),
    (5, 1, 10, 1, 8, j_halo._T2D_STEP_S_PER_PX),
])
def test_choose_halo_matches_jax_at_its_constants(steps, extent, plane_px, batch, n_gates,
                                                  t_step):
    want = j_halo.choose_halo(steps, extent, plane_px, batch, n_gate_planes=n_gates, t_step=t_step)
    got = halo.choose_halo(steps, extent, plane_px, batch, n_gate_planes=n_gates, t_step=t_step,
                           **_V5E)
    assert got == want


def test_effective_halo_clamps_and_refuses_one_row():
    assert halo.effective_halo(8, 24, 4, 20, 2) == 3
    assert halo.effective_halo(0, 24, 4, 20, 2) == 1
    assert halo.effective_halo(None, 24, 176, 1216, 4) == halo.choose_halo(24, 176, 1216, 4)
    with pytest.raises(ValueError):
        halo.effective_halo(1, 24, 1, 20, 2)


def test_exchange_count_formulas_are_jax_s():
    for steps in (1, 5, 8, 24):
        for k in range(1, 9):
            assert exchange_counts.expected_ppermutes_nd(steps, k) == \
                hlo_checks.expected_ppermutes_nd(steps, k)
            for has_sparse in (True, False):
                assert exchange_counts.expected_ppermutes_2d(steps, k, has_sparse) == \
                    hlo_checks.expected_ppermutes_2d(steps, k, has_sparse)


@pytest.mark.parametrize("steps, halo_k, with_sparse", [(24, 4, True), (24, 2, True), (6, 2, False),
                                                        (7, 8, True)])
def test_exchange_counter_matches_the_formulas(steps, halo_k, with_sparse):
    """Twice the port's exchange pairs per forward is the JAX package's
    collective-permute count, at the effective (clamped) K."""
    g, b, s = _t(*_inputs(5, n=1, h=16, w=8))
    mesh = make_mesh(spatial=4)
    k = halo.effective_halo(halo_k, steps, 4, 8, 1)
    halo.exchanges = 0
    cspn2d_spatial(g, b, s if with_sparse else None, mesh=mesh, steps=steps, halo=halo_k)
    assert 2 * halo.exchanges == exchange_counts.expected_ppermutes_2d(steps, k, with_sparse)
    guide, feat = _t(*_volume(6, (1, 16, 3, 4), 26))
    halo.exchanges = 0
    cspn_nd_spatial(guide, feat, mesh=mesh, steps=steps, halo=halo_k)
    assert 2 * halo.exchanges == exchange_counts.expected_ppermutes_nd(steps, k)


def test_mesh_refuses_what_it_cannot_run():
    # a data axis of 2 is two ranks' (DDP): one process holds one data index
    with pytest.raises(ValueError, match="process group of 2 x 2 ranks"):
        make_mesh(data=2, spatial=2)
    with pytest.raises(ValueError):
        make_mesh(spatial=0)
    g, b, _ = _t(*_inputs(6, h=15))
    with pytest.raises(ValueError, match="split"):
        cspn2d_spatial(g, b, mesh=make_mesh(spatial=2))


def _model_grads(model, *inputs):
    out = model(*inputs)
    loss = (out * torch.linspace(-1.0, 2.0, out.numel(), dtype=F64).reshape(out.shape)).sum()
    return out.detach(), torch.autograd.grad(loss, [p for p in model.parameters()])


@pytest.mark.parametrize("spatial_halo", [None, 2])
def test_sharded_cspn_unet_matches_unsharded(spatial_halo):
    """ResNet-18 CSPN-UNet, train mode, 32x48 frames, float64: the same
    weights with the CSPN's rows over 2 blocks give the unsharded output
    and every parameter's gradient."""
    from cspn_tpu_torch.models.unet import cspn_unet_resnet18

    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((2, 32, 48, 4)), dtype=F64)
    x[..., 3] = torch.tensor((rng.random((2, 32, 48)) < 0.1) * 3.0)
    models = [cspn_unet_resnet18(cspn_steps=5, generator=torch.Generator().manual_seed(0),
                                 spatial_mesh=mesh, spatial_halo=spatial_halo).to(F64)
              for mesh in (None, make_mesh(spatial=2))]
    models[1].load_state_dict(models[0].state_dict())
    (want, want_g), (got, got_g) = (_model_grads(m, x) for m in models)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    for a, e in zip(got_g, want_g):
        torch.testing.assert_close(a, e, rtol=1e-7, atol=1e-9)


def test_sharded_stereo_matches_unsharded():
    """PSMNetCSPN (max_disp 32: D = 8 over 2 blocks), train mode, float64."""
    from cspn_tpu_torch.models.stereo import PSMNetCSPN

    rng = np.random.default_rng(9)
    left, right = (torch.tensor(rng.standard_normal((2, 32, 48, 3)), dtype=F64) for _ in range(2))
    models = [PSMNetCSPN(max_disp=32, features=4, cspn_steps=5, spatial_mesh=mesh,
                         generator=torch.Generator().manual_seed(0)).to(F64)
              for mesh in (None, make_mesh(spatial=2))]
    models[1].load_state_dict(models[0].state_dict())
    (want, want_g), (got, got_g) = (_model_grads(m, left, right) for m in models)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    for a, e in zip(got_g, want_g):
        torch.testing.assert_close(a, e, rtol=1e-7, atol=1e-9)
