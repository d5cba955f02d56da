"""The paddle-semantics 2D CSPN (ops/cspn_paddle2d_cuda.py; csrc/paddle2d.cu
runs it on the card from the raw guide in cspn_nd's layouts) against the
JAX package's fused 2D kernel `_cspn2d_paddle_vjp` in interpret mode and
`jax.grad` of `cspn_nd_pallas`.

On the CPU the wrapper runs the kernel's plain version
(`paddle2d_reference`, cspn_nd_reference in the caller's layout).  Inputs
come from numpy seeds.  Tolerances: forward rtol 1e-5, atol 1e-5 (24
steps; JAX flips the gates into its reference order and sums in another
order), as tests/test_cspn_pallas.py:351-363; gradients rtol 1e-4, atol
1e-5, as tests/test_cspn_pallas.py:366-389, with guidance away from exact
zeros (ROADMAP.md Queue 3, trap 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.ops import cspn_pallas
from cspn_tpu_torch.ops import cspn_paddle2d_cuda as p2
from cspn_tpu_torch.ops.cspn import cspn_nd

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [0, 1, 12, 13, 24])
@pytest.mark.parametrize("c", [1, 2])
def test_layout_and_plain_propagation_match_the_tpu_kernel(c, steps):
    """The wrapper's plain route in both of cspn_nd's layouts against the
    TPU kernel, at the march's launch splits (12 steps a launch)."""
    rng = np.random.default_rng(20 + c + steps)
    guide = rng.standard_normal((2, 13, 17, 8 * c)).astype(np.float32)
    guide[0, 4, 5] = 0.0  # a pixel whose gates are all zero: centre weight 1
    feat = rng.standard_normal((2, 13, 17, c)).astype(np.float32)
    want = np.asarray(cspn_pallas._cspn2d_paddle_vjp(jnp.asarray(guide), jnp.asarray(feat), steps,
                                                     True))
    before = p2.launches
    got = p2.cspn2d_paddle_cuda(torch.from_numpy(guide), torch.from_numpy(feat), steps=steps)
    assert p2.launches == before  # CPU tensors: the plain version
    assert got.shape == feat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    cf = p2.cspn2d_paddle_cuda(torch.from_numpy(guide).movedim(-1, 1),
                               torch.from_numpy(feat).movedim(-1, 1), steps=steps, channel_first=True)
    assert cf.shape == (2, c, 13, 17)
    assert torch.equal(cf.movedim(1, -1), got)
    assert torch.equal(cspn_nd(torch.from_numpy(guide), torch.from_numpy(feat), steps=steps), got)


@pytest.mark.parametrize("channel_first", [False, True])
def test_gradients_match_jax_grad_of_cspn_nd_pallas(channel_first):
    rng = np.random.default_rng(5)
    n, h, w, c = 1, 10, 14, 2
    shape = (n, h, w, 8 * c)
    guide = ((0.1 + rng.random(shape)) * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    feat = rng.standard_normal((n, h, w, c)).astype(np.float32)
    assert cspn_pallas.paddle2d_fits_vmem(h, w)  # JAX routes the map to its fused kernel

    def loss_j(g, f):
        return jnp.sum(cspn_pallas.cspn_nd_pallas(g, f, kernel_size=3, steps=4) ** 2)

    want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(guide), jnp.asarray(feat))
    lay = (lambda t: t.movedim(-1, 1)) if channel_first else (lambda t: t)
    g = lay(torch.from_numpy(guide)).requires_grad_(True)
    f = lay(torch.from_numpy(feat)).requires_grad_(True)
    out = p2.cspn2d_paddle_cuda(g, f, steps=4, channel_first=channel_first)
    got = torch.autograd.grad((out ** 2).sum(), (g, f))
    unlay = (lambda t: t.movedim(1, -1)) if channel_first else (lambda t: t)
    for a, b in zip(got, want):
        np.testing.assert_allclose(unlay(a).numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    # cspn_nd on CPU tensors runs the same function (the reference backend)
    g2 = lay(torch.from_numpy(guide)).requires_grad_(True)
    out2 = cspn_nd(g2, f.detach(), steps=4, channel_first=channel_first)
    (d_g,) = torch.autograd.grad((out2 ** 2).sum(), (g2,))
    np.testing.assert_allclose(unlay(d_g).numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-5)


def test_layout_refuses_bad_arguments():
    with pytest.raises(ValueError, match="C\\*8"):
        p2.cspn2d_paddle_cuda(torch.zeros(1, 5, 7, 15), torch.zeros(1, 5, 7, 2))
    with pytest.raises(ValueError, match="C\\*8"):
        p2.cspn2d_paddle_cuda(torch.zeros(1, 16, 5, 7), torch.zeros(1, 2, 5, 6), channel_first=True)
    with pytest.raises(ValueError, match="4-d"):
        p2.cspn2d_paddle_cuda(torch.zeros(1, 3, 5, 7, 26), torch.zeros(1, 3, 5, 7, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        p2._check_inputs(torch.zeros(1, 5, 7, 8), torch.zeros(1, 5, 7, 1), False)


def test_cuda_launches_at_the_launch_splits():
    """ceil(steps / 12) march launches a forward, none at 0 steps (a copy)."""
    assert [p2.cuda_launches(s) for s in (0, 1, 11, 12, 13, 24, 25)] == [0, 1, 1, 1, 2, 2, 3]
