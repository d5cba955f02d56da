"""The tiled 2D CSPN forward's schedule (ops/cspn_cuda.py: plan_tiles,
use_tiled; csrc/cspn2d_tiled.cu runs it on the card) against the JAX
package's row-tiled kernel and its oracle.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Here a test-local PyTorch emulation of its schedule -- the
plan, plain steps on each halo-extended tile with out-of-image cells held
at 0, the interiors stitched -- is held against JAX's
`cspn2d_tiled(..., interpret=True)` with `_tiled_rows_budget` shrunk to
force several row tiles (as tests/test_cspn_pallas.py:117-138 does), and
against `cspn2d_reference`.  Inputs come from numpy seeds; float32 on both
sides, rtol 1e-5, atol 1e-6 (the normalization sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.ops import cspn_pallas
from cspn_tpu.ops import cspn_ref as jref
from cspn_tpu_torch.ops import cspn_cuda, cspn_ref
from cspn_tpu_torch.ops.neighbors import OFFSETS_2D_REFERENCE, shift

torch.set_num_threads(1)

@pytest.mark.parametrize("h, w, steps, k, tile", [
    (352, 1216, 24, 8, 32), (75, 101, 24, 8, 32), (1, 1, 1, 8, 32), (20, 27, 6, 4, 8),
    (33, 65, 9, 8, 32), (7, 5, 0, 3, 2),
])
def test_plan_tiles_covers_each_pixel_once(h, w, steps, k, tile):
    plan = cspn_cuda.plan_tiles(h, w, steps, k, tile)
    assert sum(plan.launch_steps) == steps and all(0 < s <= plan.halo for s in plan.launch_steps)
    assert plan.halo >= k
    hits = np.zeros((h, w), np.int64)
    for ty in range(plan.grid[0]):
        for tx in range(plan.grid[1]):
            r0, r1, c0, c1 = plan.interior(ty, tx)
            assert r0 < r1 and c0 < c1  # no tile without a pixel
            hits[r0:r1, c0:c1] += 1
            e0, e1, f0, f1 = plan.extended(ty, tx)
            assert min(r0 - e0, e1 - r1, c0 - f0, f1 - c1) >= plan.halo
    assert (hits == 1).all()


def test_plan_tiles_refuses_bad_arguments():
    with pytest.raises(ValueError):
        cspn_cuda.plan_tiles(0, 5, 3)
    with pytest.raises(ValueError):
        cspn_cuda.plan_tiles(5, 5, -1)


def test_use_tiled_by_the_working_set():
    """The tiled kernel runs every forward that no backward follows, at
    any working set against the L2 (it is the faster one at every shape
    of the paths on the card); a forward that cspn2d_bwd follows runs
    cspn2d_fwd, the same march storing its states for the backward."""
    assert cspn_cuda.use_tiled(for_backward=False)
    assert not cspn_cuda.use_tiled(for_backward=True)


def emulate_tiled(g_cf, blur, sparse, steps, norm_type, k, tile):
    """The tiled kernel's schedule in plain PyTorch: prep (keep * gate_d and
    base, once), then per launch and tile, plain steps on the extended tile
    whose out-of-image cells have gates and base 0 (so they stay 0) and
    whose own edge reads zeros, the interiors stitched into the output."""
    n, _, h, w = g_cf.shape
    gates, center = cspn_ref.normalize_affinity_2d(g_cf.movedim(1, -1), norm_type)
    x0 = blur
    if sparse is not None:
        mask = torch.sign(sparse)
        keep = 1.0 - mask
        base = keep * center * x0 + mask * x0
        gates = gates * keep[..., None]
    else:
        base = center * x0
    plan = cspn_cuda.plan_tiles(h, w, steps, k, tile)
    p = plan.halo + plan.tile  # pad so every extended tile lies inside the padded image

    def pad(t):
        return torch.nn.functional.pad(t, (p, p, p, p))

    gates_p, base_p = pad(gates.movedim(-1, 1)), pad(base)
    x = x0
    for k_steps in plan.launch_steps:
        x_p, out = pad(x), torch.empty_like(x)
        for ty in range(plan.grid[0]):
            for tx in range(plan.grid[1]):
                e0, e1, f0, f1 = (v + p for v in plan.extended(ty, tx))
                g_t, b_t, y = gates_p[..., e0:e1, f0:f1], base_p[..., e0:e1, f0:f1], x_p[..., e0:e1, f0:f1]
                for _ in range(k_steps):
                    acc = b_t
                    for d, off in enumerate(OFFSETS_2D_REFERENCE):
                        acc = acc + g_t[:, d] * shift(y, off, axes=(-2, -1))
                    y = acc
                r0, r1, c0, c1 = plan.interior(ty, tx)
                out[:, r0:r1, c0:c1] = y[:, r0 + p - e0:r1 + p - e0, c0 + p - f0:c1 + p - f0]
        x = out
    return x


def _inputs(rng, n, h, w, with_sparse):
    g = rng.standard_normal((n, h, w, 8)).astype(np.float32)
    g[0, :3, :4] = 0.0  # all-zero guidance: the 0/0 guard
    b = (1.0 + 9.0 * rng.random((n, h, w))).astype(np.float32)
    s = None
    if with_sparse:
        s = np.where(rng.random((n, h, w)) < 0.1, 1.0 + 9.0 * rng.random((n, h, w)), 0.0)
        s = np.where(rng.random((n, h, w)) < 0.2, -s, s).astype(np.float32)
    return g, b, s


@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
def test_tiled_schedule_matches_jax_tiled_kernel_and_oracle(monkeypatch, norm_type, with_sparse):
    rng = np.random.default_rng(11 + with_sparse + 2 * (norm_type == "8sum_abs"))
    steps = 6
    g, b, s = _inputs(rng, 2, 20, 27, with_sparse)
    js = None if s is None else jnp.asarray(s)
    # 20 rows pad to 24; budget 32 - 2 x 8 halo -> 16-row tiles: two row tiles
    monkeypatch.setattr(cspn_pallas, "_tiled_rows_budget", lambda w: 32)
    want_tiled = np.asarray(cspn_pallas.cspn2d_tiled(jnp.asarray(g), jnp.asarray(b), js, steps=steps,
                                                     norm_type=norm_type, interpret=True))
    want = np.asarray(jref.cspn2d_reference(jnp.asarray(g), jnp.asarray(b), js, steps=steps,
                                            norm_type=norm_type))
    np.testing.assert_allclose(want_tiled, want, rtol=1e-5, atol=1e-6)
    ts = None if s is None else torch.from_numpy(s)
    g_cf = torch.from_numpy(g).movedim(-1, 1)
    # 8x8 interiors with a 4-deep halo: 3 x 4 tiles, launches of 4 and 2 steps
    got = emulate_tiled(g_cf, torch.from_numpy(b), ts, steps, norm_type, k=4, tile=8)
    np.testing.assert_allclose(got.numpy(), want_tiled, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_reach_a_kernel():
    rng = np.random.default_rng(3)
    g, b, s = (torch.from_numpy(a) for a in _inputs(rng, 4, 9, 11, True))
    before = (cspn_cuda.launches, cspn_cuda.tiled_launches, cspn_cuda.bwd_launches)
    g.requires_grad_(True)
    out = cspn_cuda.cspn2d_cuda(g, b, s, steps=5)
    out.sum().backward()
    assert (cspn_cuda.launches, cspn_cuda.tiled_launches, cspn_cuda.bwd_launches) == before
    assert torch.equal(out, cspn_ref.cspn2d_reference(g, b, s, steps=5))


def test_kernel_kinds_name_the_tile_kernels_and_the_probe():
    """The profiler's kinds: the tile kernels and the probe, and the
    forward that keeps its states (its own kernel name, on the same march
    as the tiled forward)."""
    from cspn_tpu_torch.utils import profiling

    kinds = [profiling._kind(k) for k in (
        "(anonymous namespace)::cspn2d_tiled_kernel(float const*, float const*, float const*, float*, int, int, int)",
        "(anonymous namespace)::paddle2d_kernel(float const*, float const*, float const*, float*, int, int, int)",
        "void (anonymous namespace)::step_probe_f32_kernel<false>(void const*, float const*, float*, int)",
        "(anonymous namespace)::step_probe_bf16_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int)",
        "void (anonymous namespace)::cspn2d_fwd_kernel<true>((anonymous namespace)::MarchArgs)",
    )]
    assert kinds == ["cspn2d_tiled", "paddle2d", "step_probe", "step_probe", "cspn2d_fwd"]
