"""The port's `demo` subcommand (cspn_tpu_torch/cli.py:cmd_demo) against the
JAX package's (cspn_tpu/cli.py:cmd_demo): the same numpy draws of guidance
and features, cspn_nd, Adam at 1e-3 (torch.optim.Adam's defaults and
update are optax.adam's), the same `iter=NN  out=X` lines.  On the CPU
both run their reference cspn_nd.  Tolerance: rtol 1e-5 on the printed
losses; the port's unrounded losses within the print's rounding of JAX's.
"""

import re

import pytest
import torch

from cspn_tpu import cli as jcli
from cspn_tpu_torch import cli

torch.set_num_threads(1)

_LINE = re.compile(r"^iter=(\d\d)  out=(-?\d+\.\d{4})$")


def _printed(text: str) -> list[float]:
    lines = [ln for ln in text.splitlines() if ln.startswith("iter=")]
    matches = [_LINE.match(ln) for ln in lines]
    assert all(matches), lines
    assert [int(m.group(1)) for m in matches] == list(range(len(matches)))
    return [float(m.group(2)) for m in matches]


@pytest.mark.parametrize("dim", [2, pytest.param(3, marks=pytest.mark.slow)])
def test_demo_prints_the_losses_jax_prints(capsys, dim):
    args = ["demo", "--dim-num", str(dim), "--prop-step", "3", "--iter-num", "2",
            "--batch-size", "1"]
    jcli.main(args)
    want = _printed(capsys.readouterr().out)
    parsed = cli.build_parser().parse_args(args + ["--device", "cpu"])
    losses = parsed.fn(parsed)
    got = _printed(capsys.readouterr().out)
    assert len(got) == len(want) == 2
    for a, b, raw in zip(got, want, losses):
        assert abs(a - b) <= 1e-5 * abs(b)
        assert abs(raw - b) <= 5e-5 + 1e-5 * abs(b)


def test_demo_defaults_and_device():
    args = cli.build_parser().parse_args(["demo"])
    assert (args.dim_num, args.feat_chan, args.prop_kernel, args.prop_step, args.batch_size,
            args.iter_num, args.device) == (3, 1, 3, 24, 3, 20, "cuda")
