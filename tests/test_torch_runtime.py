"""The port's data, config, loss and metric code against the JAX package's:
same seeds and inputs, equal (or float-equal) outputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu import config as jconfig
from cspn_tpu.data import datasets as jdatasets
from cspn_tpu.data import transforms as jtransforms
from cspn_tpu.train import factory as jfactory
from cspn_tpu.train import logging as jlogging
from cspn_tpu.train import loss as jloss
from cspn_tpu.train import metrics as jmetrics
from cspn_tpu_torch import config
from cspn_tpu_torch.data import DataLoader, datasets, transforms
from cspn_tpu_torch.train import factory, logging, loss, metrics

torch.set_num_threads(1)


@pytest.mark.parametrize("style", ["smooth", "edges", "edges_mono"])
@pytest.mark.parametrize("seed, idx, hw", [(0, 0, (32, 48)), (3, 5, (64, 96)), (1, 2, (228, 304))])
def test_synthetic_dataset_equals_jax(style, seed, idx, hw):
    kw = dict(length=8, hw=hw, n_sample=500, seed=seed, return_raw_rgb=True, style=style)
    want = jdatasets.SyntheticDepthDataset(**kw)[idx]
    got = datasets.SyntheticDepthDataset(**kw)[idx]
    assert set(got) == set(want) == {"rgbd", "depth", "raw_rgb"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError):
        datasets.SyntheticDepthDataset(style="edge")


@pytest.mark.parametrize("denom", ["total", "valid"])
def test_create_sparse_depth_equals_jax(denom):
    depth = np.random.default_rng(0).random((57, 76)).astype(np.float32)
    depth[:10] = 0.0
    want = jdatasets.create_sparse_depth(depth, 200, np.random.default_rng(7), denom)
    got = datasets.create_sparse_depth(depth, 200, np.random.default_rng(7), denom)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        datasets.create_sparse_depth(depth, 200, np.random.default_rng(7), "all")


def test_normalize_equals_jax():
    arr = np.random.default_rng(1).random((5, 6, 3)).astype(np.float32)
    assert np.array_equal(transforms.Normalize()(arr), jtransforms.Normalize()(arr))
    assert np.array_equal(transforms.IMAGENET_MEAN, jtransforms.IMAGENET_MEAN)
    assert np.array_equal(transforms.IMAGENET_STD, jtransforms.IMAGENET_STD)


def test_batches_stack_in_order():
    """The eval loader (run_eval's): in-order batches, the short last one kept."""
    ds = datasets.SyntheticDepthDataset(length=5, hw=(8, 12), n_sample=10)
    got = list(DataLoader(ds, 2, num_workers=2))
    assert [b["rgbd"].shape[0] for b in got] == [2, 2, 1]
    assert np.array_equal(got[1]["depth"][1], ds[3]["depth"])
    assert len(list(DataLoader(ds, 2, drop_last=True))) == 2


@pytest.mark.parametrize("split, seed, crop_hw", [("val", 0, None), ("train", None, None), ("val", 3, (32, 48))])
def test_build_dataset_matches_jax(split, seed, crop_hw):
    cfg = dataclasses.replace(config.PRESETS["synthetic_smoke"])
    cfg.data = dataclasses.replace(cfg.data, crop_hw=crop_hw)
    got = factory.build_dataset(cfg, split, seed=seed)
    want = jfactory.build_dataset(jconfig.PRESETS["synthetic_smoke"], split, seed=seed)
    assert len(got) == len(want)
    if crop_hw is None:  # the JAX factory ignores crop_hw for synthetic data
        assert np.array_equal(got[1]["rgbd"], want[1]["rgbd"])
    else:
        assert got[0]["rgbd"].shape == (*crop_hw, 4)
    # the file datasets read their manifest (tests/test_torch_datasets.py holds them to
    # JAX's); an unknown dataset raises as in the JAX factory
    nyu = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="nyudepth",
                                                            eval_list="/nonexistent/val.csv"))
    with pytest.raises(FileNotFoundError):
        factory.build_dataset(nyu, "val")
    bad = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="imagenet"))
    with pytest.raises(ValueError, match="unknown dataset"):
        factory.build_dataset(bad, "val")


def test_presets_equal_jax():
    assert list(config.PRESETS) == list(jconfig.PRESETS)
    for name, cfg in config.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfig.PRESETS[name]), name
    assert dataclasses.asdict(config.RunConfig()) == dataclasses.asdict(jconfig.RunConfig())


def _pred_and_gt(seed=0, shape=(2, 24, 40)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 10.0, shape).astype(np.float32)
    gt[rng.random(shape) < 0.3] = 0.0  # invalid ground truth
    pred = (gt + rng.normal(0.0, 0.5, shape)).astype(np.float32)
    pred[rng.random(shape) < 0.1] = -0.2  # pred <= 0: LG10/iRMSE/iMAE masks
    pred[0, 0, :5] = 0.0
    return pred, gt


@pytest.mark.parametrize("name", ["masked_l1_loss", "berhu_loss"])
def test_losses_match_jax(name):
    pred, gt = _pred_and_gt(1)
    want = getattr(jloss, name)(jnp.asarray(pred), jnp.asarray(gt))
    got = getattr(loss, name)(torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert loss.LOSSES["l1"] is loss.masked_l1_loss


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_error_matches_jax(seed):
    pred, gt = _pred_and_gt(seed)
    want = jmetrics.evaluate_error(jnp.asarray(gt), jnp.asarray(pred))
    got = metrics.evaluate_error(torch.from_numpy(gt), torch.from_numpy(pred))
    assert tuple(got) == metrics.METRIC_KEYS == jmetrics.METRIC_KEYS
    for k in metrics.METRIC_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_error_averager_and_report_match_jax():
    jav, tav = jmetrics.ErrorAverager(), metrics.ErrorAverager()
    for seed, bs in ((0, 2), (1, 3)):
        pred, gt = _pred_and_gt(seed)
        jav.update(jmetrics.evaluate_error(jnp.asarray(gt), jnp.asarray(pred)), bs)
        tav.update(metrics.evaluate_error(torch.from_numpy(gt), torch.from_numpy(pred)), bs)
    assert tav.total == jav.total == 5
    for k in metrics.METRIC_KEYS:
        np.testing.assert_allclose(tav.average[k], jav.average[k], rtol=1e-5, atol=1e-7)
    avg = {k: round(v, 3) for k, v in tav.average.items()}
    assert logging.format_error("eval", 1, 2, 0.5, avg, avg) == jlogging.format_error(
        "eval", 1, 2, 0.5, avg, avg)
    assert logging.format_error("train", 0, 7, 1.0, avg) == jlogging.format_error("train", 0, 7, 1.0, avg)
