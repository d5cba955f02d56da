"""Gradients of the port's plain 2D CSPN against the JAX package's.

`cspn_ref.cspn2d_reference` is the plain version of both CUDA kernels:
its autograd is what csrc/cspn2d_bwd.cu computes, and chip_smoke.py and
tests/test_torch_cuda.py hold the kernel against it on the card.  Here,
on the CPU, the same inputs (numpy, from a seed) and the same cotangent
(not all ones) go through
  - jax.grad of the JAX oracle `cspn_tpu.ops.cspn_ref.cspn2d_reference`, and
  - jax.grad of `cspn2d_pallas(..., interpret=True)`, which runs the TPU
    backward kernel `_bwd_kernel` itself, as tests/test_cspn_pallas.py does,
and are compared with torch autograd of the port's plain version.

Every case carries an all-zero-gates pixel (its eight neighbours' guidance
is 0: zero gates, center 1, zero gradient, no NaN) and, with sparse, a
negative sample (mask = sign = -1, keep = 2).  Tolerance rtol 1e-4,
atol 1e-5 in f32 (the frameworks sum in different orders, and the adjoint
accumulates over the steps).

At a guidance entry that is exactly 0 the JAX oracle and the TPU kernel
disagree: `jnp.abs` has derivative 1 at 0, while the kernel takes sign(0) = 0
in the normalization's quotient rule, as torch.abs does (and so the torch
reference model).  The port follows the kernel: the oracle comparison skips
those entries, and the kernel comparison covers them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.ops import cspn_ref as jref
from cspn_tpu.ops.cspn_pallas import cspn2d_pallas
from cspn_tpu_torch.ops import cspn_cuda, cspn_ref

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, n, h, w, with_sparse):
    rng = np.random.default_rng(seed)
    guidance = rng.standard_normal((n, h, w, 8), dtype=np.float32)
    guidance[0, 2:7, 2:7, :] = 0.0  # pixel (4, 4) of image 0 gathers only zeros
    blur = rng.standard_normal((n, h, w), dtype=np.float32)
    ct = rng.standard_normal((n, h, w), dtype=np.float32)
    sparse = None
    if with_sparse:
        sparse = (rng.random((n, h, w)) < 0.1).astype(np.float32) * np.abs(
            rng.standard_normal((n, h, w))
        ).astype(np.float32)
        sparse[n - 1, h // 2, w // 2] = -1.5
    return guidance, blur, sparse, ct


def _port_grads(fn, g, b, s, ct):
    gt = torch.from_numpy(g).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = fn(gt, bt, None if s is None else torch.from_numpy(s))
    (out * torch.from_numpy(ct)).sum().backward()
    dg = torch.zeros_like(gt) if gt.grad is None else gt.grad  # steps=0: out is blur
    return dg.numpy(), bt.grad.numpy()


def _jax_grads(fn, g, b, s, ct):
    s_j = None if s is None else jnp.asarray(s)
    dg, db = jax.grad(lambda g, b: jnp.sum(fn(g, b, s_j) * ct), argnums=(0, 1))(
        jnp.asarray(g), jnp.asarray(b)
    )
    return np.asarray(dg), np.asarray(db)


def _assert_grads_close(got, want):
    for name, a, b in zip(("dguidance", "dblur"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [1, 4, 9, 24])
@pytest.mark.parametrize("shape", [(2, 13, 17), (2, 24, 40)])
def test_plain_grads_match_jax_reference(shape, steps, with_sparse, norm_type):
    g, b, s, ct = _inputs(steps, *shape, with_sparse)
    want = _jax_grads(
        lambda g, b, s: jref.cspn2d_reference(g, b, s, steps=steps, norm_type=norm_type),
        g, b, s, ct)
    got = _port_grads(
        lambda g, b, s: cspn_ref.cspn2d_reference(g, b, s, steps=steps, norm_type=norm_type),
        g, b, s, ct)
    keep = g != 0.0  # where |.| has one derivative
    assert keep.mean() > 0.9
    _assert_grads_close((got[0][keep], got[1]), (want[0][keep], want[1]))
    # guidance at (4, 4) feeds only zero-gates pixels: no gradient
    assert np.all(got[0][0, 4, 4] == 0.0)


@pytest.mark.parametrize("norm_type", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("with_sparse", [True, False])
@pytest.mark.parametrize("steps", [1, 4, 9])
def test_plain_grads_match_tpu_backward_kernel(steps, with_sparse, norm_type):
    g, b, s, ct = _inputs(10 + steps, 2, 9, 11, with_sparse)
    want = _jax_grads(
        lambda g, b, s: cspn2d_pallas(g, b, s, steps=steps, norm_type=norm_type, interpret=True),
        g, b, s, ct)
    # the kernel wrapper on CPU tensors: its plain version, autograd-native
    before = cspn_cuda.bwd_launches
    got = _port_grads(
        lambda g, b, s: cspn_cuda.cspn2d_cuda(g, b, s, steps=steps, norm_type=norm_type),
        g, b, s, ct)
    assert cspn_cuda.bwd_launches == before  # the plain version launches no kernel
    _assert_grads_close(got, want)


def test_steps_zero_is_the_identity():
    g, b, s, ct = _inputs(0, 1, 5, 6, True)
    dg, db = _port_grads(lambda g, b, s: cspn_ref.cspn2d_reference(g, b, s, steps=0), g, b, s, ct)
    assert np.all(dg == 0.0)
    np.testing.assert_array_equal(db, ct)
