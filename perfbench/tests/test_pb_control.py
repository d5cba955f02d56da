"""The control: the reference put in the program's place in the next
precision below the configuration's has to come out not correct.

On the CPU, at a size the CPU holds: served frames (int8 where the server
computes bf16, int4 where it computes int8).  On the card (marked `cuda`),
at each cell's own size on three seeds, what perfbench/calibrate.py reads:
the served control, the TF32 training control and the half-batch fault
fail the cell's limits, and the program's own readings pass them:

    python3 -m pytest -m cuda perfbench/tests/test_pb_control.py -q
"""

import json

import pytest
import torch

from perfbench import calibrate
from perfbench.harness import cell as cells
from perfbench.harness import check
from perfbench.tests import pb_helpers as h

SEEDS = (2147483711, 2147483713, 2147483719)


@pytest.mark.parametrize("name", ["nyu_serve_mixed", "nyu_eval_b128"])
def test_served_control_is_not_correct(name):
    cell = h.tiny(name)
    r = calibrate.serve_readings(cell, h.SEED, 1.5, h.CPU)
    assert check.judge(r["program"], cell.limits)[0], r
    assert check.judge(r["program_bf16"], cell.limits)[0], r
    assert not check.judge(r["control"], cell.limits)[0], r
    assert not check.judge(r["control_bf16"], cell.limits)[0], r


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cells' own sizes")
    from cspn_tpu_torch.ops import _build

    _build.build()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (cells.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_at_the_cells_size(name, card):
    cell = cells.load_cell(name)
    for seed in SEEDS:
        if cell.traffic["kind"] == "train":
            r = calibrate.train_readings(cell, seed, card)
            assert not check.judge(r["fault_half_batch"], cell.limits)[0], r
        else:
            r = calibrate.serve_readings(cell, seed, 15.0, card)
            assert check.judge(r["program_bf16"], cell.limits)[0], r
            assert not check.judge(r["control_bf16"], cell.limits)[0], r
        assert check.judge(r["program"], cell.limits)[0], r
        assert not check.judge(r["control"], cell.limits)[0], r
