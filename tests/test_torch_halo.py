"""The sharded 2D CSPN's local segment (ops/cspn_ref.py:
halo_segment_reference, the plain version of csrc/cspn2d_halo_seg.cu and
csrc/cspn2d_halo_seg_bwd.cu) against the JAX package's fused segment
`cspn_pallas.cspn2d_halo_segment(..., interpret=True)`, forward and VJP.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Inputs come from numpy seeds; the port runs float64 and
JAX float32 (it casts to f32), so the tolerances are JAX's rounding: rtol
and atol 1e-5 for the segment, 1e-4 for its gradients.  The gates are
normal draws, away from exact zeros (ROADMAP.md Queue 3, trap 7).
"""

import jax
import numpy as np
import pytest
import torch

from cspn_tpu.ops import cspn_pallas
from cspn_tpu_torch.ops import cspn_halo_cuda, cspn_ref

torch.set_num_threads(1)


def _segment_inputs(seed, n=2, he=12, w=20):
    rng = np.random.default_rng(seed)
    gates = rng.standard_normal((n, 8, he, w)).astype(np.float32) / 4
    base = rng.standard_normal((n, he, w)).astype(np.float32)
    keep = (1.0 - np.sign(rng.standard_normal((n, he, w)) * (rng.random((n, he, w)) < 0.2)))
    x = rng.standard_normal((n, he, w)).astype(np.float32)
    ct = rng.standard_normal((n, he, w)).astype(np.float32)
    return gates, base, keep.astype(np.float32), x, ct


@pytest.mark.parametrize("with_keep", [True, False])
@pytest.mark.parametrize("k_steps", [1, 3, 8])
def test_halo_segment_matches_jax(k_steps, with_keep):
    gates, base, keep, x, ct = _segment_inputs(k_steps)
    if not with_keep:
        keep = None

    def jax_fwd_vjp(*args):
        def seg(g, b, x, *k):
            return cspn_pallas.cspn2d_halo_segment(g, b, k[0] if k else None, x, k_steps,
                                                   interpret=True)

        *primals, ct_ = args
        out, vjp = jax.vjp(seg, *primals)
        return out, vjp(ct_)

    primals = [gates, base, x] + ([keep] if with_keep else [])
    want, want_grads = jax.jit(jax_fwd_vjp)(*primals, ct)
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in primals]
    g, b, xx = ts[:3]
    kk = ts[3] if with_keep else None
    got = cspn_ref.halo_segment_reference(g, b, kk, xx, k_steps)
    got_grads = torch.autograd.grad(got, ts, torch.tensor(ct, dtype=torch.float64))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, a, e in zip(("d gates", "d base", "d x", "d keep"), got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4, atol=1e-4, err_msg=name)


def test_wrapper_on_the_cpu_is_the_plain_version():
    """A CPU tensor goes to halo_segment_reference because it lies on the
    CPU: the same values and gradients, no kernel launch counted."""
    gates, base, keep, x, ct = (torch.tensor(a, requires_grad=True) for a in _segment_inputs(5))
    before = (cspn_halo_cuda.launches, cspn_halo_cuda.bwd_launches)
    got = cspn_halo_cuda.cspn2d_halo_segment(gates, base, keep, x, 4)
    want = cspn_ref.halo_segment_reference(gates, base, keep, x, 4)
    assert torch.equal(got, want)
    for a, e in zip(torch.autograd.grad(got, (gates, base, keep, x), ct),
                    torch.autograd.grad(want, (gates, base, keep, x), ct)):
        assert torch.equal(a, e)
    assert (cspn_halo_cuda.launches, cspn_halo_cuda.bwd_launches) == before
