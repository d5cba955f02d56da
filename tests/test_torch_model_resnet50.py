"""The port's ResNet-50 CSPN-UNet (the nyu_eval trunk) against the JAX
package's at 32x48, cspn_steps=8, in train-mode BN and in eval-mode BN with
real batch statistics; and, marked `slow`, at nyu_eval's 228x304 with 24
steps in both modes and both norms.  Float64 on both sides, for the reason
given in tests/test_torch_model.py; tolerance rtol 1e-4, atol 1e-5."""

import numpy as np
import pytest
import torch

from test_torch_model import ATOL, RTOL, batch_32x48, jax_reference, port_forward

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def r50():
    x = batch_32x48()
    ref = jax_reference(50, True, x)
    del ref["v32"]  # ~0.9 GB this file does not use
    return x, ref


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resnet50_forward_matches_jax(r50, mode):
    x, ref = r50
    variables, want = ref[mode]
    got = port_forward(50, True, variables, x, train=mode == "train")
    assert got.shape == want.shape == (2, 32, 48)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def full_size_case(hw, mode: str, norm: str, steps: int = 24):
    """(port output, JAX output) of the ResNet-50 CSPN-UNet at `hw` (b2,
    JAX's init from PRNGKey(0), `steps` CSPN steps at `norm`), float64 on
    both sides, in train-mode BN or in eval-mode BN with real batch
    statistics (tests/test_torch_model.py:jax_reference's rule)."""
    import functools

    import jax
    import jax.numpy as jnp

    from cspn_tpu.data import SyntheticDepthDataset as JaxSyntheticDepthDataset
    from cspn_tpu.models import unet as junet
    from cspn_tpu_torch.models import convert, unet

    ds = JaxSyntheticDepthDataset(length=2, hw=hw, n_sample=500, seed=5)
    x = np.stack([ds[i]["rgbd"] for i in range(2)]).astype(np.float64)
    kw = dict(cspn_steps=steps, cspn_norm_type=norm, cspn_backend="reference")
    m_train, m_eval = (junet._make(50, True, train=t, **kw) for t in (True, False))
    v = jax.tree.map(np.asarray, jax.jit(m_train.init)(jax.random.PRNGKey(0),
                                                       jnp.asarray(x[:1], jnp.float32)))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        out, upd = jax.jit(functools.partial(m_train.apply, mutable=["batch_stats"]))(
            v64, jnp.asarray(x))
        if mode == "eval":
            stats = jax.tree.map(lambda new, old: (np.asarray(new) - 0.9 * old) / 0.1,
                                 upd["batch_stats"], v64["batch_stats"])
            v64 = {"params": v64["params"], "batch_stats": stats}
            out = jax.jit(m_eval.apply)(v64, jnp.asarray(x))
        want = np.asarray(out)
    model = unet._make(50, True, cspn_steps=steps, cspn_norm_type=norm).double()
    convert.load_jax_variables(model, v64)
    model.train(mode == "train")
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy(), want


@pytest.mark.slow
@pytest.mark.parametrize("norm", ["8sum", "8sum_abs"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resnet50_full_size_forward_matches_jax(mode, norm):
    """nyu_eval's geometry: 228x304, 24 steps, both norms; ~1 min and a few
    GB a case on the CPU."""
    got, want = full_size_case((228, 304), mode, norm)
    assert got.shape == want.shape == (2, 228, 304)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
