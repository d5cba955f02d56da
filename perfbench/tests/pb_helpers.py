"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
program and the reference run their plain versions there."""

from __future__ import annotations

import dataclasses
import time

import torch

from perfbench import run
from perfbench.harness import cell as cells

CPU = torch.device("cpu")
SEED = 2147483659  # past 32 signed bits, as the driver's seeds are


def tiny(name: str, size=(48, 64), steps: int = 8, limits=None) -> cells.Cell:
    c = cells.load_cell(name)
    config = dict(c.config, arch="resnet18", frame=list(size), n_sample=24,
                  cspn_steps=steps)
    config["train"] = dict(config["train"], batch=4)
    tr = dict(c.traffic)
    if tr["kind"] == "train":
        tr.update(batch=4, pool_batches=4, trace_steps=2)
    elif tr["loop"] == "open":
        tr.update(rate_rps=10, check_per_size=2)
    else:
        tr.update(request_frames=8, pool_frames=16, check_frames=4)
    return dataclasses.replace(c, config=config, traffic=tr, limits=limits or c.limits)


def run_line(cell, seconds: float = 1.5, trace: bool = False, seed: int = SEED) -> dict:
    return run.run_cell(cell, seed, seconds, trace, CPU, time.monotonic())
