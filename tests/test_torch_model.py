"""The port's CSPN-UNet (cspn_tpu_torch/models) against the JAX package's.

Weights cross through models/convert.py from the JAX `model.init(PRNGKey(0))`.

Full-forward comparisons run in float64 on both sides.  At 32x48 the
randomly initialized network is ill-conditioned in float32: a 1e-6
relative change of the input moves the ResNet-50 output by ~2% (BN over the
4 values per channel that layer4 sees at 1x2 with a batch of 2), and even
ResNet-18 differs between float32 and float64 beyond rtol 1e-4.  So two
correct float32 implementations cannot agree to rtol 1e-4 there, while in
float64 they agree to ~3e-7 (the JAX model casts the heads to float32
before its CSPN).  Tolerance rtol 1e-4, atol 1e-5, as tests/test_golden.py.

Eval-mode BN runs with running statistics set to real batch statistics,
recovered exactly from one mutable JAX apply: B = (S_new - 0.9 S_old) / 0.1
(eval-mode BN at the init statistics is numerically meaningless).

The golden file is reproduced in float32, as tests/test_golden.py does.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu.data import SyntheticDepthDataset as JaxSyntheticDepthDataset
from cspn_tpu.models import decoder as jdecoder
from cspn_tpu.models import unet as junet
from cspn_tpu_torch.models import convert, unet
from cspn_tpu_torch.models.decoder import unpool2x

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cspn_unet_resnet18_32x48.npz")


def jax_reference(depth: int, use_cspn: bool, x: np.ndarray, with_eval: bool = True) -> dict:
    """JAX init (float32, PRNGKey(0)) and float64 train-mode (and, with
    `with_eval`, eval-mode) outputs."""
    make = junet._make
    m_train = make(depth, use_cspn, cspn_steps=8, cspn_backend="reference", train=True)
    m_eval = make(depth, use_cspn, cspn_steps=8, cspn_backend="reference", train=False)
    v = jax.tree.map(np.asarray, jax.jit(m_train.init)(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        out_train, upd = jax.jit(functools.partial(m_train.apply, mutable=["batch_stats"]))(
            v64, jnp.asarray(x, jnp.float64)
        )
        stats = jax.tree.map(lambda new, old: (np.asarray(new) - 0.9 * old) / 0.1,
                             upd["batch_stats"], v64["batch_stats"])
        ref = {"v32": v, "train": (v64, np.asarray(out_train))}
        if with_eval:
            v_eval = {"params": v64["params"], "batch_stats": stats}
            ref["eval"] = (v_eval, np.asarray(jax.jit(m_eval.apply)(v_eval, jnp.asarray(x, jnp.float64))))
        return ref


def port_forward(depth: int, use_cspn: bool, variables, x: np.ndarray, train: bool,
                 **model_kw) -> np.ndarray:
    model = unet._make(depth, use_cspn, cspn_steps=8, **model_kw).double()
    convert.load_jax_variables(model, variables)
    model.train(train)
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def batch_32x48(n=2):
    ds = JaxSyntheticDepthDataset(length=n, hw=(32, 48), n_sample=64, seed=5)
    return np.stack([ds[i]["rgbd"] for i in range(n)]).astype(np.float64)


@pytest.fixture(scope="module")
def r18():
    x = batch_32x48()
    return x, jax_reference(18, True, x)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_resnet18_forward_matches_jax(r18, mode):
    x, ref = r18
    variables, want = ref[mode]
    got = port_forward(18, True, variables, x, train=mode == "train")
    assert got.shape == want.shape == (2, 32, 48)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_baseline_forward_matches_jax():
    x = batch_32x48()
    ref = jax_reference(18, False, x, with_eval=False)
    variables, want = ref["train"]
    got = port_forward(18, False, variables, x, train=True)
    assert got.shape == (2, 32, 48)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_converted_state_dict_is_the_jax_tree(r18):
    _, ref = r18
    v = ref["v32"]
    model = unet.cspn_unet_resnet18(cspn_steps=8)
    sd = convert.convert_jax_variables(v, model)
    assert set(sd) == set(model.state_dict())
    enc = v["params"]["encoder"]
    np.testing.assert_array_equal(sd["conv1_1.weight"].numpy(),
                                  enc["conv1_1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["layer2.0.downsample.1.weight"].numpy(),
                                  enc["layer2_0"]["ds_bn"]["BatchNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["layer1.1.bn2.running_var"].numpy(),
                                  v["batch_stats"]["encoder"]["layer1_1"]["bn2"]["BatchNorm_0"]["var"])
    assert sd["gud_up_proj_layer5.conv1.weight"].shape == (1, 64, 3, 3)
    assert sd["gud_up_proj_layer6.conv1.weight"].shape == (8, 64, 3, 3)


def _edit(tree, path, value=None, delete=False):
    tree = jax.tree.map(lambda a: a, tree)  # copy the containers
    node = tree
    for p in path[:-1]:
        node = node[p]
    if delete:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return tree


def test_converter_fails_loudly(r18):
    _, ref = r18
    v = ref["v32"]
    model = unet.cspn_unet_resnet18(cspn_steps=8)
    head = ("params", "gud_up_proj_layer6", "conv1", "kernel")
    with pytest.raises(KeyError, match="without a JAX leaf"):
        convert.convert_jax_variables(_edit(v, head, delete=True), model)
    with pytest.raises(ValueError, match="shape"):
        convert.convert_jax_variables(_edit(v, head, np.zeros((3, 3, 64, 7), np.float32)), model)
    with pytest.raises(KeyError, match="does not have"):
        convert.convert_jax_variables(
            _edit(v, ("params", "gud_up_proj_layer7"), {"conv1": {"kernel": np.zeros((3, 3, 64, 1))}}),
            model)
    with pytest.raises(KeyError, match="unmapped JAX leaf"):
        convert.convert_jax_variables(
            _edit(v, ("params", "gud_up_proj_layer5", "conv1", "qscale"), np.ones(1)), model)
    with pytest.raises(KeyError, match="unmapped JAX collections"):
        convert.convert_jax_variables(dict(v, qcache={}), model)


def test_reproduces_golden_from_converted_jax_init():
    # tests/test_golden.py:18-28: eval-mode BN at the init statistics, f32
    ds = JaxSyntheticDepthDataset(length=1, hw=(32, 48), n_sample=64, seed=5)
    x = ds[0]["rgbd"][None]
    m_j = junet.cspn_unet_resnet18(cspn_steps=8, cspn_backend="reference")
    v = jax.tree.map(np.asarray, jax.jit(m_j.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    model = convert.load_jax_variables(unet.cspn_unet_resnet18(cspn_steps=8), v).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    g = np.load(_GOLDEN)
    np.testing.assert_allclose(out.mean(), g["mean"], rtol=1e-4)
    np.testing.assert_allclose(out.std(), g["std"], rtol=1e-4)
    np.testing.assert_allclose(out[0, :6, :6], g["corner"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out[0, 14:18, 22:26], g["center"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("hw, out_hw", [((3, 4), (6, 8)), ((3, 4), (5, 7)), ((8, 10), (15, 19))])
def test_unpool2x_matches_jax(hw, out_hw):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jdecoder.unpool2x(jnp.asarray(x), *out_hw))
    got = unpool2x(torch.from_numpy(x).permute(0, 3, 1, 2), *out_hw).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(228, 304), (352, 1216), (32, 48), (13, 17)])
def test_ceil_half_chain_matches_jax(hw):
    assert unet.ceil_half_chain(*hw) == junet.ceil_half_chain(*hw)


def test_seeded_init_is_reproducible_and_he_normal():
    a = unet.cspn_unet_resnet18(cspn_steps=2, generator=torch.Generator().manual_seed(3))
    b = unet.cspn_unet_resnet18(cspn_steps=2, generator=torch.Generator().manual_seed(3))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    w = a.conv2.weight.detach()  # 512 x 512 x 3 x 3: flax he_normal, truncated at 2 std
    std = (2.0 / (512 * 9)) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    np.testing.assert_allclose(float(w.std()), (2.0 / (512 * 9)) ** 0.5, rtol=0.02)
