"""The tile kernels that keep their states, emulated against the JAX package.

csrc/cspn2d_fwd.cu (the 2D CSPN forward that keeps its states for the
backward), the replay of csrc/cspn2d_bwd.cu, and csrc/cspn2d_halo_seg.cu
and csrc/cspn2d_halo_seg_bwd.cu (the sharded segment's forward, which keeps
its states when a backward follows, and its backward) run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Here test-local PyTorch
emulations of their schedules, on inputs made from numpy seeds, are held
against the JAX package's TPU kernels run in interpret mode and against
the port's plain version:

- the states march (csrc/cspn2d_march.cuh: march_tile, march_launches): the
  plan's launches in order, each extended tile stepped K at a time from
  the state the launch before it stored; the first launch loads the gates
  (folded from the raw guidance of the tile and a 1-pixel ring, or the
  segment's given gates times keep) and stores its interiors' folded
  gates and base, the later launches read that copy; after every step t
  the interiors are stitched into x_t.  Each x_t against
  `cspn_ref.cspn2d_reference` run t steps, the output against
  `cspn_pallas.cspn2d_pallas(..., interpret=True)`, and the backward
  through the kept states (tests/test_torch_cspn2d_redesign.py's
  reverse-tile and epilogue emulations) against autograd of the plain
  version and, at 9 steps (three launches, the last ragged), `jax.vjp` of
  the TPU kernel (each such call costs ~3.5 s here; that file holds the
  reverse tiles to it at every step count); the replay route (the march
  over steps - 1 steps) keeps the same states and gates;
- the segment backward: the reverse tiles with x_0 = x on the states the
  segment's forward kept (the states march over K steps with keep folded
  at load, emulate_segment_forward) and the keep epilogue (d gate = keep
  Gbar, d keep = sum_d gate_d Gbar_d), against `jax.vjp` of
  `cspn_pallas.cspn2d_halo_segment(..., interpret=True)` and autograd of
  `cspn_ref.halo_segment_reference` (tests/test_torch_halo_march.py holds
  the forward's routes and states).

The map is a ragged 20 x 27 on 8 x 8 tiles with K = 4, so that launches
are uneven; every 2D case has an all-zero guidance corner and, with
sparse, negative samples.  Float32 throughout.  The 2D tolerances are
tests/test_torch_cspn2d_redesign.py's (rtol 1e-5; atol 1e-6 for values,
1e-5 for gradients: the emulations and the references sum the same terms
in other orders); the segment's are tests/test_torch_halo.py's (rtol and
atol 1e-5 for the output, 1e-4 for the gradients), with the gates normal
draws away from exact zeros (ROADMAP.md Queue 3, trap 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_cspn2d_redesign import (
    _fold,
    _inputs,
    _plain_grads,
    _step,
    emulate_epilogue,
    emulate_reverse_tiles,
)

from cspn_tpu.ops import cspn_pallas
from cspn_tpu_torch.ops import cspn_cuda, cspn_ref

torch.set_num_threads(1)

RTOL, ATOL, ATOL_GRAD = 1e-5, 1e-6, 1e-5
SEG_TOL, SEG_TOL_GRAD = 1e-5, 1e-4
H, W, TILE, K = 20, 27, 8, 4


def _pad(t, p):
    return F.pad(t, (p, p, p, p))


def emulate_march(x0, steps, first, k=K, tile=TILE):
    """march_launches: `steps` steps from x0 [N,H,W] in the plan's launches.
    `first(ext, ring)` gives launch 0's gates [N,8,*] and base [N,*] on
    the padded extended tile `ext` (`ring`: it and a 1-pixel ring), 0
    outside the image.  Returns (x_steps, the folded gates and base the
    first launch stored, [x_1, .., x_{steps-1}])."""
    n, h, w = x0.shape
    plan = cspn_cuda.plan_tiles(h, w, steps, k, tile)
    p = plan.halo + plan.tile + 1  # every extended tile and its ring inside the padding
    inside = _pad(torch.ones(n, h, w), p) > 0
    folded_g, folded_b = torch.zeros(n, 8, h, w), torch.zeros(n, h, w)
    states, x, t = [], x0, 0
    for launch, k_steps in enumerate(plan.launch_steps or (0,)):  # 0 steps: the fold alone
        x_p, fg_p, fb_p = _pad(x, p), _pad(folded_g, p), _pad(folded_b, p)
        stitched = [torch.empty_like(x0) for _ in range(k_steps)]
        for ty in range(plan.grid[0]):
            for tx in range(plan.grid[1]):
                e0, e1, f0, f1 = (v + p for v in plan.extended(ty, tx))
                ext = (..., slice(e0, e1), slice(f0, f1))
                if launch == 0:
                    ring = (..., slice(e0 - 1, e1 + 1), slice(f0 - 1, f1 + 1))
                    g_t, b_t = first(ext, ring)
                    g_t, b_t = g_t * inside[ext][:, None], b_t * inside[ext]
                else:  # the first launch's folded copy
                    g_t, b_t = fg_p[ext], fb_p[ext]
                r0, r1, c0, c1 = plan.interior(ty, tx)
                inner = (..., slice(r0 + p - e0, r1 + p - e0), slice(c0 + p - f0, c1 + p - f0))
                if launch == 0:
                    folded_g[..., r0:r1, c0:c1] = g_t[inner]
                    folded_b[..., r0:r1, c0:c1] = b_t[inner]
                y = x_p[ext]
                for s in range(k_steps):
                    y = _step(g_t, b_t, y)
                    stitched[s][..., r0:r1, c0:c1] = y[inner]
        states += stitched
        t += k_steps
        x = states[-1] if states else x
    assert t == steps
    return x, folded_g, folded_b, states[:-1]


def emulate_states_forward(g_cf, blur, sparse, steps, norm_type, k=K, tile=TILE):
    """csrc/cspn2d_fwd.cu: the march from blur, the first launch folding
    each tile's gates and base from the raw guidance of the tile and its
    ring.  Returns (out, folded gates, states x_1..x_{T-1})."""
    g_p, b_p = _pad(g_cf, k + tile + 1), _pad(blur, k + tile + 1)
    s_p = None if sparse is None else _pad(sparse, k + tile + 1)

    def first(ext, ring):
        g_t, b_t = _fold(g_p[ring], b_p[ring], None if s_p is None else s_p[ring], norm_type)
        return g_t[..., 1:-1, 1:-1], b_t[..., 1:-1, 1:-1]

    out, gates, _, states = emulate_march(blur, steps, first, k, tile)
    return out, gates, states


def emulate_segment_forward(gates, base, keep, x, k_steps, k=K, tile=TILE):
    """csrc/cspn2d_halo_seg.cu: the march over K steps from x on the given
    gates, keep folded in at load, the first launch storing G = keep *
    gate for the later launches and the backward.  Returns (out, G (the
    gates themselves without keep), the states x_1..x_{K-1})."""
    n, _, h, w = gates.shape
    p = k + tile + 1
    kp = torch.ones(n, h, w) if keep is None else keep
    g_p, b_p, k_p = _pad(gates, p), _pad(base, p), _pad(kp, p)

    def first(ext, _ring):
        return k_p[ext][:, None] * g_p[ext], b_p[ext]

    out, folded, _, states = emulate_march(x, k_steps, first, k, tile)
    return out, gates if keep is None else folded, states


def emulate_segment_backward(gates, base, keep, x, ct, k_steps, k=K, tile=TILE):
    """csrc/cspn2d_halo_seg_bwd.cu on what the segment's forward kept
    (emulate_segment_forward): the reverse tiles on [x, x_1..x_{K-1}] with
    G, then the keep epilogue.  Returns (d gates, d base, d keep or None,
    d x)."""
    n, _, h, w = gates.shape
    _, g, states = emulate_segment_forward(gates, base, keep, x, k_steps, k, tile)
    dx, gbar, dbase = emulate_reverse_tiles(g, [x] + states, ct,
                                            cspn_cuda.plan_tiles(h, w, k_steps, k, tile))
    if keep is None:
        return gbar, dbase, None, dx
    return keep[:, None] * gbar, dbase, (gates * gbar).sum(1), dx


def _jax_fwd_vjp(g, b, s, ct, steps, norm_type, with_vjp):
    """The TPU forward kernel's output and, with `with_vjp`, its VJP (the
    TPU backward kernel) at ct."""
    s_j = None if s is None else jnp.asarray(s)

    def fwd(g, b):
        return cspn_pallas.cspn2d_pallas(g, b, s_j, steps=steps, norm_type=norm_type,
                                         interpret=True)

    if not with_vjp:
        return np.asarray(fwd(jnp.asarray(g), jnp.asarray(b))), []
    out, vjp = jax.vjp(fwd, jnp.asarray(g), jnp.asarray(b))
    return np.asarray(out), [[np.asarray(d) for d in vjp(jnp.asarray(ct))]]


@pytest.mark.parametrize("steps", [1, 6, 9])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
def test_states_forward_matches_tpu_kernels_and_plain(norm_type, with_sparse, steps):
    g, b, s, ct = _inputs(300 + steps + 10 * with_sparse + 20 * (norm_type == "8sum_abs"),
                          2, H, W, with_sparse)
    g_cf, bt = torch.from_numpy(g).movedim(-1, 1), torch.from_numpy(b)
    st = None if s is None else torch.from_numpy(s)
    out, gates, states = emulate_states_forward(g_cf, bt, st, steps, norm_type)
    assert len(states) == steps - 1
    for t, x_t in enumerate(states, start=1):
        want = cspn_ref.cspn2d_reference(torch.from_numpy(g), bt, st, steps=t, norm_type=norm_type)
        np.testing.assert_allclose(x_t.numpy(), want.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"x_{t}")
    want_out, want_grads = _jax_fwd_vjp(g, b, s, ct, steps, norm_type, with_vjp=steps == 9)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=RTOL, atol=ATOL)
    # the replay route (the backward without kept states): the march over
    # steps - 1 steps keeps the same states and folded gates
    last, replay_gates, replay_states = emulate_states_forward(g_cf, bt, st, steps - 1,
                                                               norm_type)
    assert torch.equal(replay_gates, gates)
    assert all(torch.equal(a, x) for a, x in zip(replay_states + [last], states))
    # the backward through the kept states: reverse tiles and the epilogue
    plan = cspn_cuda.plan_tiles(H, W, steps, K, TILE)
    v0, gbar, bbar = emulate_reverse_tiles(gates, [bt] + states, torch.from_numpy(ct), plan)
    dguid, dblur = emulate_epilogue(g_cf, bt, st, v0, gbar, bbar, norm_type)
    got = (dguid.movedim(1, -1).numpy(), dblur.numpy())
    for want in want_grads + [_plain_grads(g, b, s, ct, steps, norm_type)]:
        for name, a, x in zip(("dguidance", "dblur"), got, want):
            assert np.isfinite(a).all(), name
            np.testing.assert_allclose(a, x, rtol=RTOL, atol=ATOL_GRAD, err_msg=name)


def _segment_inputs(seed, n=2, he=H, w=W):
    rng = np.random.default_rng(seed)
    gates = rng.standard_normal((n, 8, he, w)).astype(np.float32) / 4
    base = rng.standard_normal((n, he, w)).astype(np.float32)
    keep = 1.0 - np.sign(rng.standard_normal((n, he, w)) * (rng.random((n, he, w)) < 0.2))
    x = rng.standard_normal((n, he, w)).astype(np.float32)
    ct = rng.standard_normal((n, he, w)).astype(np.float32)
    return gates, base, keep.astype(np.float32), x, ct


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [1, 3, 8])
def test_segment_backward_matches_tpu_kernel_and_plain(k_steps, with_keep):
    gates, base, keep, x, ct = _segment_inputs(400 + k_steps + 10 * with_keep)
    primals = [gates, base, x] + ([keep] if with_keep else [])

    def seg(g, b, xx, *kk):
        return cspn_pallas.cspn2d_halo_segment(g, b, kk[0] if kk else None, xx, k_steps,
                                               interpret=True)

    _, vjp = jax.vjp(seg, *(jnp.asarray(a) for a in primals))
    want_jax = [np.asarray(d) for d in vjp(jnp.asarray(ct))]  # d gates, d base, d x[, d keep]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in primals]
    out = cspn_ref.halo_segment_reference(leaves[0], leaves[1], leaves[3] if with_keep else None,
                                          leaves[2], k_steps)
    want_plain = [d.numpy() for d in torch.autograd.grad(out, leaves, torch.from_numpy(ct))]
    dg, db, dk, dx = emulate_segment_backward(*(torch.from_numpy(a) for a in (gates, base)),
                                              torch.from_numpy(keep) if with_keep else None,
                                              torch.from_numpy(x), torch.from_numpy(ct), k_steps)
    got = [dg, db, dx] + ([dk] if with_keep else [])
    for want in (want_jax, want_plain):
        for name, a, e in zip(("d gates", "d base", "d x", "d keep"), got, want):
            assert np.isfinite(a.numpy()).all(), name
            np.testing.assert_allclose(a.numpy(), e, rtol=SEG_TOL_GRAD, atol=SEG_TOL_GRAD,
                                       err_msg=name)
