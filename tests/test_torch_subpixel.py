"""The subpixel decoder (cspn_tpu_torch/models/decoder.py) against the JAX package's.

The port's `SubpixelUnpoolConv`, its blocks and `CSPNUNet(subpixel=True)`
run the `unpool2x -> crop -> k x k conv` pair as a half-resolution conv into
four phase groups plus depth_to_space2, as the JAX package's default
decoder does; `subpixel=False` is the plain unpool + conv.  Weights cross
through models/convert.py from JAX `init(PRNGKey(0))`, and the port's two
forms are held against JAX and against each other.

Comparisons run in float64 on both sides (`jax.enable_x64`) with rtol 1e-4,
atol 1e-5, as tests/test_torch_model.py explains: at 32x48 the randomly
initialized network is ill-conditioned in float32.  The golden file is
reproduced in float32, as tests/test_golden.py does.  One composed train
step through each form against JAX's `make_train_step` is in
tests/test_torch_train_step.py, which shares one JAX step between them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_model import batch_32x48, jax_reference, port_forward

from cspn_tpu.data import SyntheticDepthDataset as JaxSyntheticDepthDataset
from cspn_tpu.models import decoder as jdecoder
from cspn_tpu.models import unet as junet
from cspn_tpu_torch.models import convert, decoder, unet

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cspn_unet_resnet18_32x48.npz")
FORMS = ["subpixel", "plain"]


def _jax_apply(module, x: np.ndarray):
    """float32 init from PRNGKey(0), float64 apply (train-mode BN updates
    the batch statistics).  Returns (float64 variables, output NHWC, the
    updated batch statistics or None)."""
    v = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        if "batch_stats" in v64:
            out, upd = module.apply(v64, jnp.asarray(x), mutable=["batch_stats"])
            return v64, np.asarray(out), jax.tree.map(np.asarray, upd["batch_stats"])
        return v64, np.asarray(module.apply(v64, jnp.asarray(x))), None


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k, cin, features, hw, crop", [
    (5, 16, 128, (6, 7), (11, 14)),  # phase split, odd height crop
    (3, 16, 128, (6, 7), (12, 13)),  # phase split, odd width crop
    (5, 8, 64, (5, 6), (9, 11)),  # zero-padded common kernel
    (5, 8, 12, (5, 6), (10, 12)),
    (3, 8, 12, (5, 6), (9, 11)),
])
def test_subpixel_unpool_conv_matches_jax(k, cin, features, hw, crop):
    x = np.random.default_rng(k + features).standard_normal((2, *hw, cin))
    v64, want, _ = _jax_apply(jdecoder.SubpixelUnpoolConv(features, k, *crop), x)
    m = convert.load_jax_variables(decoder.SubpixelUnpoolConv(cin, features, k).double(), v64)
    with torch.no_grad():
        got = m(_nchw(x), *crop)
        plain = F.conv2d(decoder.unpool2x(_nchw(x), *crop), m.weight, padding=k // 2)
    assert got.shape == (2, features, *crop)
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form", FORMS)
def test_gudi_up_conv_matches_jax(form):
    x = np.random.default_rng(1).standard_normal((2, 5, 6, 8))
    crop = (9, 11)
    subpixel = form == "subpixel"
    v64, want, stats = _jax_apply(jdecoder.GudiUpConv(12, *crop, train=True, subpixel=subpixel), x)
    m = convert.load_jax_variables(decoder.GudiUpConv(8, 12, subpixel).double(), v64).train()
    with torch.no_grad():
        got = m(_nchw(x), *crop)
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)
    sd = m.state_dict()
    for key, arr in convert.convert_jax_tree("batch_stats", stats).items():
        np.testing.assert_allclose(sd[key].numpy(), arr, rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("crop", [(0, 0), (9, 11)])
def test_up_proj_matches_jax(crop):
    x = np.random.default_rng(2).standard_normal((2, 5, 6, 8))
    v64, want, _ = _jax_apply(jdecoder.UpProj(12, *crop, train=True), x)
    m = convert.load_jax_variables(decoder.UpProj(8, 12).double(), v64).train()
    with torch.no_grad():
        got = m(_nchw(x), *crop)
    assert got.shape == (2, 12, *(crop if crop[0] else (10, 12)))
    np.testing.assert_allclose(_nhwc(got), want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def r18():
    x = batch_32x48()
    return x, jax_reference(18, True, x)


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("form", FORMS)
def test_cspn_unet_forms_match_jax_default(r18, form, mode):
    x, ref = r18
    variables, want = ref[mode]
    got = port_forward(18, True, variables, x, train=mode == "train", subpixel=form == "subpixel")
    assert got.shape == want.shape == (2, 32, 48)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def golden_outputs():
    """The converted JAX init through the port's two forms, float32,
    eval-mode BN at the init statistics (tests/test_golden.py:18-28)."""
    ds = JaxSyntheticDepthDataset(length=1, hw=(32, 48), n_sample=64, seed=5)
    x = ds[0]["rgbd"][None]
    m_j = junet.cspn_unet_resnet18(cspn_steps=8, cspn_backend="reference")
    v = jax.tree.map(np.asarray, jax.jit(m_j.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    outs = {}
    for form in FORMS:
        model = unet.cspn_unet_resnet18(cspn_steps=8, subpixel=form == "subpixel")
        model = convert.load_jax_variables(model, v).eval()
        with torch.no_grad():
            outs[form] = model(torch.from_numpy(x)).numpy()
    return outs


def test_subpixel_reproduces_golden(golden_outputs):
    out = golden_outputs["subpixel"]
    g = np.load(_GOLDEN)
    np.testing.assert_allclose(out.mean(), g["mean"], rtol=1e-4)
    np.testing.assert_allclose(out.std(), g["std"], rtol=1e-4)
    np.testing.assert_allclose(out[0, :6, :6], g["corner"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out[0, 14:18, 22:26], g["center"], rtol=1e-3, atol=1e-4)


def test_subpixel_and_plain_agree(golden_outputs):
    # tests/test_golden.py:56-65: both decoder forms, the same weights
    np.testing.assert_allclose(golden_outputs["subpixel"], golden_outputs["plain"], rtol=1e-4,
                               atol=1e-5)
