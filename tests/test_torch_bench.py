"""The port's bench (cspn_tpu_torch/bench.py, `python -m cspn_tpu_torch
bench`) on the CPU at a tiny size: one parseable stdout line with the JAX
bench's four keys, the three paths' frames/s on stderr, and the chain of
forwards fed back into the sparse channel as the JAX package's bench.py
chains them.  The card's numbers come from chip_smoke.py."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cspn_tpu_torch import bench
from cspn_tpu_torch.cli import build_parser, cmd_bench

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(_REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_bench_prints_one_line_with_the_four_keys(capsys):
    got = bench.run_bench(batch=2, hw=(32, 48), arch="resnet18", repeats=1, trials=1,
                          device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"] and line == got["line"]
    fps = got["frames_per_s"]
    assert set(fps) == set(bench.PATHS) and all(v > 0 for v in fps.values())
    headline = fps["int8"] if fps["int8"] >= fps["kernel"] else fps["kernel"]
    assert line["metric"] == "nyu_eval_frames_per_s"
    assert line["value"] == round(headline, 2) > 0
    assert line["vs_baseline"] == round(headline / fps["reference"], 3)
    assert line["unit"].startswith("frames/s/cpu (resnet18") and "32x48, b2" in line["unit"]
    assert ("int8-serving" in line["unit"]) == (fps["int8"] >= fps["kernel"])
    for path in bench.PATHS:
        assert f"bench: {path} path " in err


def test_chained_forwards_match_jax_bench():
    """bench.py:_make_repeated's chain (JAX) and the port's on a stand-in
    model y = mean over channels of x^2: the same input after 3 forwards."""
    x = np.random.default_rng(0).standard_normal((2, 5, 6, 4)).astype(np.float32)

    class Stand:
        def apply(self, variables, xi):
            return (xi ** 2).mean(-1)

    want = jax.jit(_jax_bench()._make_repeated(Stand(), None, 3))(None, jnp.asarray(x))
    got = bench.chained(lambda xi: (xi ** 2).mean(-1), torch.from_numpy(x), 3)()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_bench_subcommand_keeps_the_fixed_shape():
    args = build_parser().parse_args(["bench", "--device", "cpu"])
    assert args.fn is cmd_bench and args.device == "cpu"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["bench", "--batch", "2"])
    defaults = bench.run_bench.__defaults__
    assert defaults[:5] == (128, (228, 304), "resnet50", 8, 5)  # bench.py's b128, 8 x 5
