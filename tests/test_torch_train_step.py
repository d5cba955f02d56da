"""One composed train step of the port against the JAX package's: the
port's default (subpixel) decoder, and its plain form, against JAX's
default model (the two forms compute one function).

The same batch and the converted JAX weights (`model.init(PRNGKey(0))`) go
through `cspn_tpu.train.loop.make_train_step` (forward in train-mode BN,
masked L1, value_and_grad, SGD-Nesterov with weight decay) and the port's
`train.loop.make_train_step`.  Compared: the loss, every gradient (the JAX
ones from jax.value_and_grad of the same loss), the BN running statistics
after the step and the parameters after SGD, at rtol 1e-4, atol 1e-5.

Both sides run in float64 (`jax.enable_x64`; the JAX model still runs its
CSPN in float32): at 32x48 the randomly initialized network is
ill-conditioned in float32 (ROADMAP.md Queue 3, trap 5).  Valid ground
truth is >= 2, kept apart from the predictions, because the L1 derivative's
sign flips under rounding where a prediction equals its ground truth.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.data import SyntheticDepthDataset as JaxSyntheticDepthDataset
from cspn_tpu.models import unet as junet
from cspn_tpu.train import loop as jloop
from cspn_tpu.train import state as jstate
from cspn_tpu.train.loss import masked_l1_loss
from cspn_tpu_torch.models import convert, unet
from cspn_tpu_torch.train import loop, state

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4


def _batch(hw, n=2, seed=7):
    ds = JaxSyntheticDepthDataset(length=n, hw=hw, n_sample=64, seed=5)
    x = np.stack([ds[i]["rgbd"] for i in range(n)]).astype(np.float64)
    rng = np.random.default_rng(seed)
    gt = 2.0 + np.abs(rng.standard_normal((n, *hw)))
    gt[rng.random((n, *hw)) < 0.2] = 0.0  # invalid pixels exercise the loss mask
    return x, gt


def _jax_step(depth, steps, x, gt):
    model = junet._make(depth, True, cspn_steps=steps, cspn_backend="reference", train=True)
    v = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        st = jstate.TrainState.create(
            apply_fn=model.apply, params=v64["params"], batch_stats=v64["batch_stats"],
            tx=jstate.make_optimizer(LR, momentum=MOMENTUM, weight_decay=WD, nesterov=True))
        xj, gtj = jnp.asarray(x), jnp.asarray(gt)

        @jax.jit
        def loss_and_grads(params):
            def compute(p):
                out, _ = model.apply({"params": p, "batch_stats": st.batch_stats}, xj,
                                     mutable=["batch_stats"])
                return masked_l1_loss(out, gtj), out
            return jax.value_and_grad(compute, has_aux=True)(params)

        (loss, out), grads = loss_and_grads(st.params)
        new_st, loss_step, _ = jloop.make_train_step(model, "l1")(st, xj, gtj)
        to_np = functools.partial(jax.tree.map, np.asarray)
        return dict(v64=v64, loss=float(loss), loss_step=float(loss_step), out=np.asarray(out),
                    grads=to_np(grads), params=to_np(new_st.params), stats=to_np(new_st.batch_stats))


def check_port_step(ref, depth, steps, x, gt, **model_kw):
    """The port's step from `ref`'s weights on the same batch against `ref`
    (`_jax_step`'s result); `model_kw` goes to the port's CSPNUNet."""
    model = convert.load_jax_variables(unet._make(depth, True, cspn_steps=steps, **model_kw).double(),
                                       ref["v64"])
    optimizer = state.make_optimizer(model.parameters(), LR, momentum=MOMENTUM, weight_decay=WD,
                                     nesterov=True)
    loss, error = loop.make_train_step(model, optimizer, "l1")(torch.from_numpy(x), torch.from_numpy(gt))

    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=RTOL)
    np.testing.assert_allclose(ref["loss_step"], ref["loss"], rtol=1e-12)
    assert np.isfinite(error["RMSE"].item())
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want_grads = convert.convert_jax_tree("params", ref["grads"])
    assert set(grads) == set(want_grads)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    want_state = {**convert.convert_jax_tree("params", ref["params"]),
                  **convert.convert_jax_tree("batch_stats", ref["stats"])}
    assert set(want_state) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, want in want_grads.items():
        np.testing.assert_allclose(grads[k], want, rtol=RTOL, atol=ATOL, err_msg=f"grad {k}")
    for k, want in want_state.items():
        np.testing.assert_allclose(sd[k], want, rtol=RTOL, atol=ATOL, err_msg=f"after the step: {k}")
    moved = [k for k in want_grads if not np.array_equal(sd[k], convert.convert_jax_tree(
        "params", ref["v64"]["params"])[k])]
    assert len(moved) == len(want_grads)  # SGD moved every parameter


@functools.lru_cache(maxsize=1)
def _reference(depth, hw, steps):
    """The batch and the JAX step on it, shared by this file's tests."""
    x, gt = _batch(hw)
    ref = _jax_step(depth, steps, x, gt)
    valid = gt > 1e-4
    assert np.abs(ref["out"] - gt)[valid].min() > 1e-3  # no L1 sign flip within rounding
    return x, gt, ref


@pytest.mark.parametrize("depth, hw, steps", [
    (18, (32, 48), 8),
    pytest.param(50, (228, 304), 24, marks=pytest.mark.slow),
])
def test_train_step_matches_jax(depth, hw, steps):
    x, gt, ref = _reference(depth, hw, steps)
    check_port_step(ref, depth, steps, x, gt)


def test_train_step_plain_decoder_matches_jax():
    """The plain unpool + conv decoder (`subpixel=False`) from the same
    weights on the same batch against the same JAX step."""
    x, gt, ref = _reference(18, (32, 48), 8)
    check_port_step(ref, 18, 8, x, gt, subpixel=False)
