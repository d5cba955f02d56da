"""The one generator of every traffic mix, from its parameters (a file under
perfbench/traffic/) and the seed.

  - open loop (`"loop": "open"`): Poisson arrivals at `rate_rps`, each
    request's size drawn independently from `sizes` with probabilities
    `weights`: i.i.d. exponential gaps and i.i.d. sizes, every request due
    within the window.  The arrivals and sizes are one realization, drawn
    from the mix's own `schedule_seed` and the same for every --seed, so
    that runs on different seeds offer the same work, bursts included, and
    the 95th percentile measures the server and not how a seed bunched
    the large requests (a seed-drawn realization moved it by 2x between
    seeds).  A longer window extends the same realization; another rate
    rescales its gaps.  The seed draws the frames each request carries.
  - closed loop (`"loop": "closed"`): one client sends `request_frames`
    frames a request, back to back.
Each request takes a contiguous run of a pool of `pool_frames` frames at
an offset the seed draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    due_s: float  # after the window's start; 0 for a closed loop
    frames: int
    offset: int  # into the frame pool


def open_schedule(params: dict, seconds: float, seed: int) -> list[Request]:
    arrivals = np.random.default_rng([params["schedule_seed"], 0])
    picks = np.random.default_rng([params["schedule_seed"], 1])
    w = np.asarray(params["weights"], dtype=np.float64)
    due, sizes, t = [], [], 0.0
    while True:  # unit exponential gaps, scaled to the rate, until the window closes
        t += float(arrivals.exponential()) / params["rate_rps"]
        if t >= seconds:
            break
        due.append(t)
        sizes.append(int(picks.choice(params["sizes"], p=w / w.sum())))
    sizes = np.asarray(sizes, dtype=np.int64)
    offsets = np.random.default_rng(seed).integers(0, params["pool_frames"] - sizes + 1)
    return [Request(i, due[i], int(sizes[i]), int(offsets[i])) for i in range(len(due))]


def closed_requests(params: dict, seed: int, count: int) -> list[Request]:
    """The first `count` requests of the closed loop."""
    rng = np.random.default_rng(seed)
    size, pool = params["request_frames"], params["pool_frames"]
    offsets = rng.integers(0, pool - size + 1, size=count)
    return [Request(i, 0.0, size, int(offsets[i])) for i in range(count)]


def check_sample(requests: list[Request], per_size: int, seed: int) -> set[int]:
    """Indices of `per_size` requests of each size, drawn from the seed: the
    requests whose answers the output check compares."""
    rng = np.random.default_rng([seed, 1])
    by_size: dict[int, list[int]] = {}
    for r in requests:
        by_size.setdefault(r.frames, []).append(r.index)
    picked = set()
    for idx in by_size.values():
        picked.update(rng.choice(idx, size=min(per_size, len(idx)), replace=False).tolist())
    return picked


def percentile(values, q: float) -> float:
    """The q-th percentile (numpy's linear rule); inf where a value is inf."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if values else math.nan
