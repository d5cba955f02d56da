"""The redesigned 2D CSPN tile kernels' schedules against the JAX package.

csrc/cspn2d_tiled.cu (the tiled forward) and csrc/cspn2d_bwd.cu (the
backward's reverse tiles and its fused epilogue) run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Here test-local PyTorch
emulations of their schedules, on inputs made from numpy seeds, are held
against the JAX package's TPU kernels run in interpret mode and against the
port's plain version:

- the prep-free tiled forward: the plan (ops/cspn_cuda.py:plan_tiles); the
  first launch folds each extended tile's gates and base from the raw
  guidance of the tile and a 1-pixel ring (out-of-image cells 0) and keeps
  a folded copy of its interior, the later launches read that copy; plain
  steps on each extended tile, the interiors stitched.  Against
  `cspn_pallas.cspn2d_tiled(..., interpret=True)` with `_tiled_rows_budget`
  shrunk to force several row tiles (as tests/test_torch_cspn_tiled.py);
- the reverse-tile backward, on kept states (here computed step by step): per
  launch (the ragged one first) and tile, the transposed stencil
  A_d[q] = G_d[q - off_d] gathered once with zero gates outside the image,
  K adjoint steps on the extended tile with its edge reading zeros, the
  interior's cotangents accumulated in the per-step order from the kept
  states and written once a launch, then the fused epilogue (the quotient
  rule on each epilogue tile and its ring, then the unshift gather).
  Against `jax.vjp` of `cspn_pallas.cspn2d_pallas(..., interpret=True)`,
  which runs the TPU backward kernel (not the JAX oracle: at the all-zero
  guidance corner jnp.abs has derivative 1 where the kernel takes sign(0) =
  0, ROADMAP trap 7), and against autograd of the port's
  `cspn_ref.cspn2d_reference`.

Every case has an all-zero guidance corner and, with sparse, negative
samples; the map is a ragged 20 x 27 on 8 x 8 tiles with K = 4 and steps
in {1, 6, 9}, so that launches are uneven.  Float32 on both sides, rtol
1e-5: the emulations and the references sum the same terms in other
orders (the normalization, the eight-term stencils, the adjoint over the
steps), which moves float32 results by a few ulps.  atol 1e-6 for the
forward; 1e-5 for the gradients, which reach 35 here and are sums over
the steps of terms as large: the two references themselves (the TPU
kernel's VJP and autograd of the plain version) differ by up to 7.6e-6
on these inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cspn_tpu.ops import cspn_pallas
from cspn_tpu_torch.ops import cspn_cuda, cspn_ref
from cspn_tpu_torch.ops.neighbors import OFFSETS_2D_REFERENCE, shift

torch.set_num_threads(1)

RTOL, ATOL, ATOL_GRAD = 1e-5, 1e-6, 1e-5
H, W, TILE, K = 20, 27, 8, 4  # ragged in both axes: 3 x 4 tiles of 8
EPI_H, EPI_W = 4, 8  # the emulated epilogue's tile (csrc: 16 x 32), ragged here too
AXES = (-2, -1)


def _inputs(seed, n, h, w, with_sparse):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, h, w, 8)).astype(np.float32)
    g[0, :3, :4] = 0.0  # all-zero guidance: the 0/0 guard, zero gates
    b = (1.0 + 9.0 * rng.random((n, h, w))).astype(np.float32)
    ct = rng.standard_normal((n, h, w)).astype(np.float32)
    s = None
    if with_sparse:
        s = np.where(rng.random((n, h, w)) < 0.1, 1.0 + 9.0 * rng.random((n, h, w)), 0.0)
        s = np.where(rng.random((n, h, w)) < 0.2, -s, s).astype(np.float32)
    return g, b, s, ct


def _fold(g_cf, blur, sparse, norm_type):
    """keep * gate_d [N,8,H,W] and base [N,H,W] of every pixel (the kernels'
    fold_pixel), from the raw guidance as the arrays hold it."""
    gates, center = cspn_ref.normalize_affinity_2d(g_cf.movedim(1, -1), norm_type)
    if sparse is None:
        return gates.movedim(-1, 1), center * blur
    mask = torch.sign(sparse)
    keep = 1.0 - mask
    return (gates * keep[..., None]).movedim(-1, 1), keep * center * blur + mask * blur


def _step(gates, base, x):
    acc = base
    for d, off in enumerate(OFFSETS_2D_REFERENCE):
        acc = acc + gates[:, d] * shift(x, off, axes=AXES)
    return acc


def _pad(t, p):
    return F.pad(t, (p, p, p, p))


def emulate_tiled_prep_free(g_cf, blur, sparse, steps, norm_type, k, tile):
    """csrc/cspn2d_tiled.cu's schedule: no prep pass, the first launch folds
    on its tiles and keeps a folded copy of its interiors."""
    n, _, h, w = g_cf.shape
    plan = cspn_cuda.plan_tiles(h, w, steps, k, tile)
    p = plan.halo + plan.tile + 1  # every extended tile and its ring inside the padding
    inside = _pad(torch.ones(n, h, w), p) > 0
    g_p, b_p = _pad(g_cf, p), _pad(blur, p)
    s_p = None if sparse is None else _pad(sparse, p)
    folded_g, folded_b = torch.empty(n, 8, h, w), torch.empty(n, h, w)
    x = blur
    for launch, k_steps in enumerate(plan.launch_steps):
        x_p, out = _pad(x, p), torch.empty_like(x)
        fg_p, fb_p = _pad(folded_g, p), _pad(folded_b, p)
        for ty in range(plan.grid[0]):
            for tx in range(plan.grid[1]):
                e0, e1, f0, f1 = (v + p for v in plan.extended(ty, tx))
                ext = (..., slice(e0, e1), slice(f0, f1))
                if launch == 0:  # fold from the raw planes of the tile and its ring
                    ring = (..., slice(e0 - 1, e1 + 1), slice(f0 - 1, f1 + 1))
                    g_t, b_t = _fold(g_p[ring], b_p[ring], None if s_p is None else s_p[ring],
                                     norm_type)
                    g_t, b_t = g_t[..., 1:-1, 1:-1], b_t[..., 1:-1, 1:-1]
                    keep = inside[ext]  # a pixel outside the image is zeroed
                    g_t, b_t = g_t * keep[:, None], b_t * keep
                else:  # the first launch's folded copy
                    g_t, b_t = fg_p[ext], fb_p[ext]
                y = x_p[ext]
                for _ in range(k_steps):
                    y = _step(g_t, b_t, y)
                r0, r1, c0, c1 = plan.interior(ty, tx)
                inner = (..., slice(r0 + p - e0, r1 + p - e0), slice(c0 + p - f0, c1 + p - f0))
                out[..., r0:r1, c0:c1] = y[inner]
                if launch == 0:
                    folded_g[..., r0:r1, c0:c1] = g_t[inner]
                    folded_b[..., r0:r1, c0:c1] = b_t[inner]
        x = out
    return x


def emulate_reverse_tiles(gates, states, ct, plan):
    """csrc/cspn2d_bwd.cu's reverse sweep on kept states (states[t] = x_t,
    t = 0 .. T-1, x_0 = blur): returns (d x_0, Gbar [N,8,H,W], bbar)."""
    n, _, h, w = gates.shape
    p = plan.halo + plan.tile
    # the transposed stencil, 0 where q - off_d (or q, by the padding) is outside
    a_p = _pad(torch.stack([shift(gates[:, d], (-off[0], -off[1]), axes=AXES)
                            for d, off in enumerate(OFFSETS_2D_REFERENCE)], 1), p)
    gbar, bbar = torch.empty(n, 8, h, w), torch.empty(n, h, w)
    v, t_hi = ct, len(states)
    for launch, k_steps in enumerate(reversed(plan.launch_steps)):
        v_p, v_out = _pad(v, p), torch.empty_like(v)
        for ty in range(plan.grid[0]):
            for tx in range(plan.grid[1]):
                e0, e1, f0, f1 = (val + p for val in plan.extended(ty, tx))
                a_t, y = a_p[..., e0:e1, f0:f1], v_p[..., e0:e1, f0:f1]
                r0, r1, c0, c1 = plan.interior(ty, tx)
                inner = (..., slice(r0 + p - e0, r1 + p - e0), slice(c0 + p - f0, c1 + p - f0))
                kept_v = []
                for _ in range(k_steps):
                    kept_v.append(y[inner])
                    acc = torch.zeros_like(y)
                    for d, off in enumerate(OFFSETS_2D_REFERENCE):
                        acc = acc + a_t[:, d] * shift(y, (-off[0], -off[1]), axes=AXES)
                    y = acc
                v_out[..., r0:r1, c0:c1] = y[inner]
                # the interior's accumulators: started at 0 or read, written once
                if launch == 0:
                    gb, bb = torch.zeros(n, 8, r1 - r0, c1 - c0), torch.zeros(n, r1 - r0, c1 - c0)
                else:
                    gb, bb = gbar[..., r0:r1, c0:c1].clone(), bbar[..., r0:r1, c0:c1].clone()
                for s, vs in enumerate(kept_v):
                    x = states[t_hi - 1 - s]
                    bb = bb + vs
                    for d, off in enumerate(OFFSETS_2D_REFERENCE):
                        gb[:, d] = gb[:, d] + vs * shift(x, off, axes=AXES)[..., r0:r1, c0:c1]
                gbar[..., r0:r1, c0:c1], bbar[..., r0:r1, c0:c1] = gb, bb
        v, t_hi = v_out, t_hi - k_steps
    return v, gbar, bbar


def emulate_epilogue(g_cf, blur, sparse, v0, gbar, bbar, norm_type):
    """The fused epilogue: per EPI_H x EPI_W tile, the quotient rule at the
    tile's pixels and a 1-pixel ring (Bbar_d[r], the cotangent of the raw
    gathered guidance), dblur at its own pixels, then the unshift
    dguid_d[q] = Bbar_d[q - off_d]."""
    n, _, h, w = g_cf.shape
    a = torch.stack([shift(g_cf[:, d], off, axes=AXES)
                     for d, off in enumerate(OFFSETS_2D_REFERENCE)], 1)  # signed raw B_d
    denom = a.abs().sum(1)
    inv = torch.where(denom > 0, 1.0 / torch.where(denom > 0, denom, 1.0), 0.0)
    ge = a * inv[:, None]
    if norm_type == "8sum_abs":
        ge = ge.abs()
    m = torch.zeros_like(blur) if sparse is None else torch.sign(sparse)
    keep = 1.0 - m
    dblur = torch.empty_like(blur)
    dguid = torch.zeros_like(g_cf)
    for i0 in range(0, h, EPI_H):
        for j0 in range(0, w, EPI_W):
            ri, rj = slice(max(i0 - 1, 0), min(i0 + EPI_H + 1, h)), slice(max(j0 - 1, 0), min(j0 + EPI_W + 1, w))
            bb, gsumbar = bbar[:, ri, rj], -bbar[:, ri, rj] * keep[:, ri, rj] * blur[:, ri, rj]
            gh = keep[:, None, ri, rj] * gbar[..., ri, rj] + gsumbar[:, None]
            t_sum = (gh * ge[..., ri, rj]).sum(1, keepdim=True)
            sg = torch.sign(a[..., ri, rj])
            iv = inv[:, None, ri, rj]
            raw = sg * (gh - t_sum) * iv if norm_type == "8sum_abs" else (gh - sg * t_sum) * iv
            oi, oj = slice(i0, min(i0 + EPI_H, h)), slice(j0, min(j0 + EPI_W, w))
            gsum = ge[..., oi, oj].sum(1)
            dblur[:, oi, oj] = v0[:, oi, oj] + bbar[:, oi, oj] * (keep[:, oi, oj] * (1.0 - gsum) + m[:, oi, oj])
            # the unshift, from the tile and its ring only (zeros beyond the image)
            ring = torch.zeros(n, 8, h + 2, w + 2)
            ring[..., ri.start + 1:ri.stop + 1, rj.start + 1:rj.stop + 1] = raw
            for d, off in enumerate(OFFSETS_2D_REFERENCE):
                dguid[:, d, oi, oj] = ring[:, d, oi.start + 1 - off[0]:oi.stop + 1 - off[0],
                                           oj.start + 1 - off[1]:oj.stop + 1 - off[1]]
    return dguid, dblur


def emulate_backward(g_cf, blur, sparse, ct, steps, norm_type, k, tile):
    """The backward on kept states, computed here step by step."""
    gates, base = _fold(g_cf, blur, sparse, norm_type)
    states = [blur]
    for _ in range(steps - 1):
        states.append(_step(gates, base, states[-1]))
    plan = cspn_cuda.plan_tiles(*blur.shape[1:], steps, k, tile)
    v0, gbar, bbar = emulate_reverse_tiles(gates, states, ct, plan)
    return emulate_epilogue(g_cf, blur, sparse, v0, gbar, bbar, norm_type)


def _jax_vjp_tpu_kernel(g, b, s, ct, steps, norm_type):
    s_j = None if s is None else jnp.asarray(s)
    _, vjp = jax.vjp(lambda g, b: cspn_pallas.cspn2d_pallas(g, b, s_j, steps=steps,
                                                            norm_type=norm_type, interpret=True),
                     jnp.asarray(g), jnp.asarray(b))
    dg, db = vjp(jnp.asarray(ct))
    return np.asarray(dg), np.asarray(db)


def _plain_grads(g, b, s, ct, steps, norm_type):
    gt, bt = torch.from_numpy(g).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    out = cspn_ref.cspn2d_reference(gt, bt, None if s is None else torch.from_numpy(s),
                                    steps=steps, norm_type=norm_type)
    return [t.numpy() for t in torch.autograd.grad(out, (gt, bt), torch.from_numpy(ct))]


@pytest.mark.parametrize("steps", [1, 6, 9])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
def test_reverse_tiles_match_tpu_backward_kernel_and_plain_autograd(norm_type, with_sparse, steps):
    g, b, s, ct = _inputs(100 + steps + 10 * with_sparse + 20 * (norm_type == "8sum_abs"),
                          2, H, W, with_sparse)
    g_cf = torch.from_numpy(g).movedim(-1, 1)
    got = emulate_backward(g_cf, torch.from_numpy(b), None if s is None else torch.from_numpy(s),
                           torch.from_numpy(ct), steps, norm_type, K, TILE)
    got = (got[0].movedim(1, -1).numpy(), got[1].numpy())
    for want in (_jax_vjp_tpu_kernel(g, b, s, ct, steps, norm_type),
                 _plain_grads(g, b, s, ct, steps, norm_type)):
        for name, a, x in zip(("dguidance", "dblur"), got, want):
            assert np.isfinite(a).all(), name
            np.testing.assert_allclose(a, x, rtol=RTOL, atol=ATOL_GRAD, err_msg=name)
    # the all-zero corner: guidance at (0, 0) feeds only zero-gate pixels
    assert np.all(got[0][0, 0, 0] == 0.0)


@pytest.mark.parametrize("steps", [1, 6, 9])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
def test_prep_free_tiles_match_jax_tiled_kernel(monkeypatch, norm_type, with_sparse, steps):
    g, b, s, _ = _inputs(200 + steps + 10 * with_sparse + 20 * (norm_type == "8sum_abs"),
                         2, H, W, with_sparse)
    js = None if s is None else jnp.asarray(s)
    # 20 rows pad to 24; a budget of 2 halos (steps rounded up to 8) + 16
    # rows -> 16-row tiles: two row tiles
    halo = -(-steps // 8) * 8
    monkeypatch.setattr(cspn_pallas, "_tiled_rows_budget", lambda w: 2 * halo + 16)
    want = np.asarray(cspn_pallas.cspn2d_tiled(jnp.asarray(g), jnp.asarray(b), js, steps=steps,
                                               norm_type=norm_type, interpret=True))
    got = emulate_tiled_prep_free(torch.from_numpy(g).movedim(-1, 1), torch.from_numpy(b),
                                  None if s is None else torch.from_numpy(s), steps, norm_type,
                                  K, TILE)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("steps, want", [
    (24, {"cspn2d_fwd": 2, "cspn2d_tiled": 2, "cspn2d_bwd_kept": 3, "cspn2d_bwd_replay": 5}),
    (25, {"cspn2d_fwd": 3, "cspn2d_tiled": 3, "cspn2d_bwd_kept": 4, "cspn2d_bwd_replay": 6}),
])
def test_cuda_launches_per_call_at_the_paths_steps(steps, want):
    """The paths run 24 steps: both forwards take ceil(24 / K) = 2
    launches (the tiled one 4 before, with its prep; the one keeping its
    states 25, a prep and a launch a step), the backward on kept states
    ceil(24 / K) + 1 = 3 (26 before), replaying ceil(23 / K) + 3 = 5 (27);
    a step more adds a ragged launch."""
    assert cspn_cuda.HALO == 12
    assert cspn_cuda.cuda_launches_per_call(steps) == want
    assert want["cspn2d_fwd"] == want["cspn2d_tiled"] <= -(-steps // cspn_cuda.HALO)
    assert want["cspn2d_bwd_kept"] <= -(-steps // cspn_cuda.HALO) + 2
    assert want["cspn2d_bwd_replay"] <= 2 * -(-steps // cspn_cuda.HALO) + 1


@pytest.mark.parametrize("steps, want", [(0, (0, 0, 0, 0)), (1, (1, 1, 2, 3)), (13, (2, 2, 3, 4))])
def test_cuda_launches_per_call_at_the_edges(steps, want):
    got = cspn_cuda.cuda_launches_per_call(steps)
    assert tuple(got[k] for k in ("cspn2d_fwd", "cspn2d_tiled", "cspn2d_bwd_kept",
                                  "cspn2d_bwd_replay")) == want


def test_compiled_tiles_and_the_paths_plans():
    """The tile kernels run 64 x 64 extended tiles: an interior of 64 - 2K,
    K = 12 (csrc/cspn2d_march.cuh), which the paths' plans follow."""
    assert (cspn_cuda.EXT, cspn_cuda.HALO, cspn_cuda.TILE) == (64, 12, 40)
    for h, w in ((228, 304), (352, 1216)):
        plan = cspn_cuda.plan_tiles(h, w, 24)
        assert plan.tile == cspn_cuda.TILE and plan.halo == cspn_cuda.HALO
        assert plan.launch_steps == (12, 12)
        assert plan.grid == (-(-h // 40), -(-w // 40))
    assert cspn_cuda.plan_tiles(75, 101, 9).launch_steps == (9,)
    assert cspn_cuda.plan_tiles(75, 101, 13).launch_steps == (12, 1)
    with pytest.raises(ValueError, match="bad tile plan"):
        cspn_cuda.plan_tiles(75, 101, 9, k=0)


def test_profiler_kinds_name_the_redesigned_kernels():
    """utils/profiling.py's kinds: both instantiations of the tiled forward
    (the first launch folding the gates, the later ones), the backward's
    reverse tiles and its epilogue."""
    from cspn_tpu_torch.utils import profiling

    kinds = [profiling._kind(k) for k in (
        "void (anonymous namespace)::cspn2d_tiled_kernel<true>(float const*, float const*, "
        "float const*, float*, float const*, float*, int, int, int, int)",
        "void (anonymous namespace)::cspn2d_tiled_kernel<false>(float const*, float const*, "
        "float const*, float*, float const*, float*, int, int, int, int)",
        "(anonymous namespace)::reverse_tile_kernel(float const*, float const*, "
        "float const*, float const*, float*, float*, float*, int, int, int, int, int, int)",
        "(anonymous namespace)::epilogue_kernel(float const*, float const*, float const*, "
        "float const*, float const*, float const*, float*, float*, int, int, int)",
    )]
    assert kinds == ["cspn2d_tiled", "cspn2d_tiled", "cspn2d_bwd", "cspn2d_bwd"]


@pytest.mark.parametrize("argv", [[], ["--routes-of", "."], ["--steps-of", "."]])
def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys, argv):
    """chip_smoke.py, the whole run, only the kernels' timing of a checkout
    (--routes-of) or only its train steps and served rates (--steps-of),
    exits non-zero and prints no result where torch.cuda.is_available()
    is false."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main(argv) == 1
    out, err = capsys.readouterr()
    assert out == "" and "needs an NVIDIA GPU" in err

