"""The sharded segment's forward on the column march, emulated against the JAX package.

csrc/cspn2d_halo_seg.cu runs the K-step segment on the halo-extended
block as the image of the 2D CSPN's column march (csrc/cspn2d_march.cuh),
keep folded into the given gates at load, in two routes with the same
values: the one that no backward follows stores only its output, the one
that a backward follows also stores x_1..x_{K-1} and G = keep * gate, and
csrc/cspn2d_halo_seg_bwd.cu then runs only the reverse tiles on them and
the keep epilogue.  The kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Here the march's schedule
(tests/test_torch_cspn2d_kept.py:emulate_march, emulate_segment_forward:
the plan's launches in order, each extended tile stepped K at a time) on
a ragged 20 x 27 block on 8 x 8 tiles with K = 4, at K = 1, 4 and 9
segment steps (one, one and three launches, the last ragged), with and
without keep, inputs from numpy seeds, is held against:

- `cspn_pallas.cspn2d_halo_segment(..., interpret=True)` (the TPU kernel
  in interpret mode) run t steps, for the output and every kept state
  x_t, and `cspn_ref.halo_segment_reference`;
- for the backward through the kept states (the reverse tiles and the
  keep epilogue, no replay), `jax.vjp` of the TPU kernel at 9 steps with
  keep and autograd of the plain segment at every case;

and `ops/cspn_halo_cuda.py:cuda_launches` is held to the launches the
schedules make.  Tolerances: tests/test_torch_halo.py's (rtol and atol
1e-5 for values, 1e-4 for gradients), the gates normal draws away from
exact zeros (ROADMAP.md Queue 3, trap 7).  Float32 throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cspn2d_kept import (
    H,
    K,
    SEG_TOL,
    SEG_TOL_GRAD,
    TILE,
    W,
    _segment_inputs,
    emulate_segment_backward,
    emulate_segment_forward,
)

from cspn_tpu.ops import cspn_pallas
from cspn_tpu_torch.ops import cspn_cuda, cspn_halo_cuda, cspn_ref

torch.set_num_threads(1)

SEEDS = {True: 600, False: 610}  # one block of inputs per keep setting, every K


def _inputs(with_keep):
    gates, base, keep, x, ct = _segment_inputs(SEEDS[with_keep])
    return gates, base, keep if with_keep else None, x, ct


@functools.lru_cache(maxsize=None)
def _jax_segment(with_keep, t):
    """The TPU kernel (interpret mode) run t steps on _inputs(with_keep)."""
    gates, base, keep, x, _ = _inputs(with_keep)
    return np.asarray(cspn_pallas.cspn2d_halo_segment(gates, base, keep, x, t, interpret=True))


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [1, 4, 9])
def test_segment_forward_matches_tpu_kernel_and_plain(k_steps, with_keep):
    """The output and every state x_t the route a backward follows keeps,
    against the TPU kernel run t steps and the plain segment; the folded
    gates are keep * gate exactly."""
    gates, base, keep, x = _torch(*_inputs(with_keep)[:4])
    out, folded, states = emulate_segment_forward(gates, base, keep, x, k_steps)
    assert len(states) == k_steps - 1
    assert torch.equal(folded, gates if keep is None else keep[:, None] * gates)
    for t, x_t in enumerate(states + [out], start=1):
        for want in (_jax_segment(with_keep, t),
                     cspn_ref.halo_segment_reference(gates, base, keep, x, t).numpy()):
            np.testing.assert_allclose(x_t.numpy(), want, rtol=SEG_TOL, atol=SEG_TOL,
                                       err_msg=f"x_{t}")


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [1, 4, 9])
def test_segment_forward_routes_agree(k_steps, with_keep):
    """The route that no backward follows (each launch from the output of
    the one before it, folding keep in again at its load) gives every state
    the states route keeps at a launch's end, and its output, value for
    value: keep * gate is exact, and the march is the same launch for
    launch."""
    gates, base, keep, x = _torch(*_inputs(with_keep)[:4])
    out, _, states = emulate_segment_forward(gates, base, keep, x, k_steps)
    y, done = x, 0
    for steps in cspn_cuda.plan_tiles(H, W, k_steps, K, TILE).launch_steps:
        y = emulate_segment_forward(gates, base, keep, y, steps)[0]
        done += steps
        assert torch.equal(y, (states + [out])[done - 1])
    assert done == k_steps and torch.equal(y, out)


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [1, 4, 9])
def test_segment_backward_on_kept_states(k_steps, with_keep):
    """The backward on the kept states against autograd of the plain
    segment, and at 9 steps with keep against jax.vjp of the TPU kernel."""
    gates, base, keep, x, ct = _inputs(with_keep)
    primals = [gates, base, x] + ([keep] if with_keep else [])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in primals]
    out = cspn_ref.halo_segment_reference(leaves[0], leaves[1], leaves[3] if with_keep else None,
                                          leaves[2], k_steps)
    wants = [[d.numpy() for d in torch.autograd.grad(out, leaves, torch.from_numpy(ct))]]
    if with_keep and k_steps == 9:
        def seg(g, b, xx, kk):
            return cspn_pallas.cspn2d_halo_segment(g, b, kk, xx, k_steps, interpret=True)

        _, vjp = jax.vjp(seg, *(jnp.asarray(a) for a in primals))
        wants.append([np.asarray(d) for d in vjp(jnp.asarray(ct))])
    dg, db, dk, dx = emulate_segment_backward(*_torch(gates, base, keep, x, ct), k_steps)
    got = [dg, db, dx] + ([dk] if with_keep else [])
    for want in wants:
        for name, a, e in zip(("d gates", "d base", "d x", "d keep"), got, want):
            assert np.isfinite(a.numpy()).all(), name
            np.testing.assert_allclose(a.numpy(), e, rtol=SEG_TOL_GRAD, atol=SEG_TOL_GRAD,
                                       err_msg=name)


@pytest.mark.parametrize("k_steps, with_keep, want", [
    (1, True, (1, 2)), (1, False, (1, 1)),
    (8, True, (1, 2)), (8, False, (1, 1)),  # kitti_sharded's K = 8 segment
    (11, True, (1, 2)), (12, True, (1, 2)), (12, False, (1, 1)),
    (13, True, (2, 3)), (13, False, (2, 2)),
    (24, True, (2, 3)), (24, False, (2, 2)),  # the b4 train segment, K = 24
    (25, True, (3, 4)),
])
def test_cuda_launches(k_steps, with_keep, want):
    """ceil(K / 12) march launches a forward, either route, and the
    backward's ceil(K / 12) reverse tiles and, with keep, its epilogue:
    what the card-only tests and chip_smoke.py count from the host's
    records."""
    assert cspn_halo_cuda.cuda_launches(k_steps, with_keep) == want
    tiles = len(cspn_cuda.plan_tiles(224, 1216, k_steps).launch_steps)
    assert want == (tiles, tiles + int(with_keep))
