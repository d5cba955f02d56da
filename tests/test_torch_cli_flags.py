"""The port's `--cspn-io-dtype` and `--debug-nans` (cspn_tpu_torch/cli.py,
utils/profiling.py:debug_nans) against the JAX package's
(cspn_tpu/cli.py:51-55,84-85,115,161-164; cspn_tpu/utils/profiling.py:31-33),
on the CPU."""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu import cli as jcli
from cspn_tpu.ops import cspn as jcspn
from cspn_tpu_torch import cli, config
from cspn_tpu_torch.models import unet
from cspn_tpu_torch.ops.cspn import cspn2d
from cspn_tpu_torch.train import evaluate
from cspn_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _jax_args(argv):
    p = argparse.ArgumentParser()
    jcli._add_common_overrides(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("argv", [[], ["--cspn-io-dtype", "bfloat16"],
                                  ["--cspn-io-dtype", "float32", "--debug-nans"]])
def test_flags_parse_as_jax(argv):
    args = cli.build_parser().parse_args(["train", "--preset", "nyu_train", *argv])
    want = _jax_args(["--preset", "nyu_train", *argv])
    assert args.debug_nans == want.debug_nans
    got_cfg, want_cfg = cli._build_config(args), jcli._build_config(want)
    assert got_cfg.model.cspn_io_dtype == want_cfg.model.cspn_io_dtype
    for sub in ("eval", "infer", "export"):  # common overrides, as JAX's
        assert cli.build_parser().parse_args([sub, *argv]).debug_nans == want.debug_nans
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["train", "--cspn-io-dtype", "float16"])


def test_cspn_io_dtype_reaches_the_op(monkeypatch):
    args = cli.build_parser().parse_args(["eval", "--preset", "synthetic_smoke", "--model",
                                          "resnet18", "--cspn-step", "2", "--cspn-io-dtype",
                                          "bfloat16", "--device", "cpu"])
    cfg = cli._build_config(args)
    model = evaluate.build_model(cfg, device="cpu")
    assert model.cspn_io_dtype == "bfloat16"
    seen = []

    def spy(*a, **kw):
        seen.append(kw["io_dtype"])
        return cspn2d(*a, **kw)

    monkeypatch.setattr(unet, "cspn2d", spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, 48, 4))
                         .astype(np.float32))
    with torch.no_grad():
        got = model(x)
        model.cspn_io_dtype = None
        plain = model(x)
    assert seen == ["bfloat16", None]
    assert torch.isfinite(got).all() and not torch.equal(got, plain)  # the inputs were rounded


def _guidance(bad: float):
    rng = np.random.default_rng(1)
    g = rng.standard_normal((1, 6, 7, 8)).astype(np.float32)
    g[0, 3, 4, 2] = bad
    return g, rng.uniform(0.5, 2.0, (1, 6, 7)).astype(np.float32)


class _Cspn(torch.nn.Module):
    def forward(self, g, b):
        return cspn2d(g, b, steps=4)


def _jax_raises(g, b) -> bool:
    before = jax.config.jax_debug_nans
    try:
        jax.config.update("jax_debug_nans", True)
        fn = jax.jit(functools.partial(jcspn.cspn2d, steps=4, backend="reference"))
        jax.block_until_ready(fn(jnp.asarray(g), jnp.asarray(b)))
        return False
    except FloatingPointError:
        return True
    finally:
        jax.config.update("jax_debug_nans", before)


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_debug_nans_raises_where_jax_debug_nans_does(bad):
    """A guidance entry of inf makes the CSPN's normalization give NaNs
    (inf / inf) that reach its output: JAX's jitted op raises under
    jax_debug_nans, and the port's op in a module raises under debug_nans.
    A guidance NaN is dropped by the normalization (no NaN comes out):
    neither raises.  Off, the port passes the NaNs through."""
    g, b = _guidance(bad)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    produces_nan = bool(torch.isnan(_Cspn()(gt, bt)).any())
    assert produces_nan == (bad == np.inf) == _jax_raises(g, b)
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        if produces_nan:
            with pytest.raises(FloatingPointError, match=r"NaN in the output \(1, 6, 7\) of _Cspn"):
                _Cspn()(gt, bt)
        else:
            assert torch.isfinite(_Cspn()(gt, bt)).all()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled() and profiling._nan_hook is None
    assert not torch.nn.modules.module._global_forward_hooks
    assert bool(torch.isnan(_Cspn()(gt, bt)).any()) == produces_nan


def test_train_debug_nans_turns_the_check_on(monkeypatch):
    """`train --debug-nans` turns the check on before it builds the trainer
    (cspn_tpu/cli.py:161-164); without the flag it stays off."""
    from cspn_tpu_torch.train import factory, loop

    calls = []

    class Trainer:
        def __init__(self, *a, **kw):
            calls.append(("trainer", torch.is_anomaly_enabled()))

        def fit(self):
            return None

    monkeypatch.setattr(loop, "Trainer", Trainer)
    monkeypatch.setattr(factory, "build_loaders", lambda cfg: (None, None))
    try:
        for flag in ([], ["--debug-nans"]):
            cli.main(["train", "--preset", "synthetic_smoke", "--device", "cpu", *flag])
    finally:
        profiling.debug_nans(False)
    assert calls == [("trainer", False), ("trainer", True)]
    assert config.PRESETS["synthetic_smoke"].model.cspn_io_dtype is None
