"""Importing a whole model trained by the reference (models/torch_import.py:
convert_cspn_state_dict, load_torch_cspn_checkpoint; train/evaluate.py:
load_eval_state(torch_checkpoint=)) against the JAX package's import
(cspn_tpu/models/torch_import.py, cspn_tpu/train/evaluate.py:56-66).

There are no reference weights here, so the checkpoint is made the way the
reference's training saves one (torch.save of a DataParallel model's state
dict, train.py:277-280) from the port's own ResNet-18 CSPN-UNet, its BN
statistics calibrated on a seeded batch (trap 3): every key under
`module.`, with the BN counters and the modules the reference builds but
never calls (`up_proj_layer*`, `post_process_layer.sum_conv`, `conv3`,
`fc`).  JAX's converter must fill every leaf of its own model from it,
which holds the port's names to the reference's.

Forwards are compared in float64 on both sides, rtol 1e-4 and atol 1e-5,
as tests/test_torch_model.py compares full forwards (trap 5).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu import config as jconfig
from cspn_tpu.models import torch_import as jimport
from cspn_tpu.models import unet as junet
from cspn_tpu.train import evaluate as jevaluate
from cspn_tpu_torch import config
from cspn_tpu_torch.models import torch_import
from cspn_tpu_torch.train import evaluate, state
from cspn_tpu_torch.utils.profiling import decoder_twin

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3
HW = (64, 96)
_EXTRA = {  # reference modules that its forward never calls, and a BN counter
    "up_proj_layer1.conv1.weight": torch.zeros(4, 4, 5, 5),
    "post_process_layer.sum_conv.weight": torch.ones(1, 8, 3, 3),
    "conv3.weight": torch.zeros(2, 2, 1, 1),
    "fc.weight": torch.zeros(10, 512),
    "fc.bias": torch.zeros(10),
    "bn1.num_batches_tracked": torch.tensor(3),
}


def _cfg(**model):
    cfg = config.PRESETS["synthetic_smoke"]
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, cspn_steps=STEPS,
                                                              **model))


def _frames(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, *HW, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """(path of the reference-format checkpoint, the port model it came from)."""
    model = evaluate.build_model(_cfg(), train=True, device="cpu", seed=3)
    evaluate.calibrate_bn_stats(model, torch.from_numpy(_frames(4, seed=1)))
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    sd.update({"module." + k: v for k, v in _EXTRA.items()})
    path = tmp_path_factory.mktemp("reference") / "best_model.pth"
    torch.save(sd, path)
    return str(path), model


def test_convert_strips_the_prefix_and_skips_what_the_reference_never_calls(reference_pth):
    path, model = reference_pth
    got = torch_import.load_torch_cspn_checkpoint(path)
    want = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v.float()) for k, v in want.items())
    # a bare state dict without the DataParallel prefix converts the same
    bare = torch_import.convert_cspn_state_dict(model.state_dict())
    assert set(bare) == set(want)


def test_jax_converter_fills_every_jax_leaf(reference_pth):
    """JAX's convert_cspn_state_dict on the checkpoint sets every parameter
    and statistic of JAX's own model, at its shape: the port's module names
    are the reference's."""
    path, model = reference_pth
    params, stats = jimport.load_torch_cspn_checkpoint(path)
    jmodel = junet._make(18, True, cspn_steps=STEPS, cspn_backend="reference")
    v = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, *HW, 4)))
    for tree, got in ((v["params"], params), (v["batch_stats"], stats)):
        want = {jax.tree_util.keystr(k): x.shape
                for k, x in jax.tree_util.tree_leaves_with_path(tree)}
        have = {jax.tree_util.keystr(k): np.shape(x)
                for k, x in jax.tree_util.tree_leaves_with_path(got)}
        assert have == want


@pytest.fixture(scope="module")
def both_imports(reference_pth):
    """JAX's load_eval_state and the port's on the checkpoint."""
    path, _ = reference_pth
    cfg_j = jconfig.PRESETS["synthetic_smoke"]
    cfg_j = dataclasses.replace(cfg_j, model=dataclasses.replace(
        cfg_j.model, cspn_steps=STEPS, cspn_backend="reference"))
    _, jstate, _ = jevaluate.load_eval_state(cfg_j, torch_checkpoint=path)
    variables = jax.tree.map(np.asarray, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    model = evaluate.load_eval_state(_cfg(), device="cpu", torch_checkpoint=path)
    return variables, model


@pytest.mark.parametrize("subpixel", [True, False], ids=["subpixel", "plain"])
def test_imported_checkpoint_evaluates_the_same_in_both_packages(both_imports, subpixel):
    variables, model = both_imports
    x = _frames(2, seed=5).astype(np.float64)
    jmodel = junet._make(18, True, cspn_steps=STEPS, cspn_backend="reference", subpixel=subpixel)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want = np.asarray(jax.jit(functools.partial(jmodel.apply))(v64, jnp.asarray(x)))
    port = decoder_twin(model, subpixel=subpixel).double().eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all() and got.shape == (2, *HW)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_eval_state_imports_and_casts(reference_pth):
    """The import goes through partial_restore, then the serving cast, the
    int8 cache and the calibration as for any checkpoint."""
    path, source = reference_pth
    model = evaluate.load_eval_state(_cfg(), device="cpu", torch_checkpoint=path)
    src = source.state_dict()
    assert all(torch.equal(v, src[k]) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    int8 = evaluate.load_eval_state(_cfg(dtype="int8"), device="cpu", torch_checkpoint=path)
    assert all(v.dtype == torch.bfloat16 for k, v in int8.state_dict().items()
               if v.is_floating_point())
    assert torch.equal(int8.state_dict()["conv1_1.weight"], src["conv1_1.weight"].bfloat16())
    from cspn_tpu_torch.utils import quant

    assert all(m.qcache for m in quant.quant_convs(int8).values())
    # partial_restore copies what matches and leaves the rest
    target = evaluate.build_model(_cfg(), device="cpu", seed=0)
    before = target.state_dict()["conv1_1.weight"].clone()
    state.partial_restore(target, {"conv1_1.weight": torch.zeros(1, 1, 1, 1)})
    assert torch.equal(target.state_dict()["conv1_1.weight"], before)
