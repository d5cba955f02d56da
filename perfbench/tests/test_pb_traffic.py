"""The traffic generator: every seed gets the same arrivals and sizes."""

import collections
import json
import pathlib

import numpy as np
import pytest

from perfbench.harness import traffic

MIX = json.loads((pathlib.Path(traffic.__file__).parent.parent / "traffic"
                  / "mixed_sizes_open.json").read_text())


def test_open_schedule_same_arrivals_for_every_seed():
    a = traffic.open_schedule(MIX, 30.0, 1)
    b = traffic.open_schedule(MIX, 30.0, 2**31 + 7)
    assert [(r.due_s, r.frames) for r in a] == [(r.due_s, r.frames) for r in b]
    assert [r.offset for r in a] != [r.offset for r in b]
    assert 0 < a[0].due_s and a[-1].due_s < 30.0
    for r in a:
        assert 0 <= r.offset <= MIX["pool_frames"] - r.frames


def test_open_schedule_is_poisson_with_iid_sizes():
    sched = traffic.open_schedule(MIX, 400.0, 3)
    n = len(sched)
    assert abs(n - MIX["rate_rps"] * 400) < 4 * (MIX["rate_rps"] * 400) ** 0.5
    dues = np.array([0.0] + [r.due_s for r in sched])
    gaps = np.diff(dues) * MIX["rate_rps"]
    assert abs(gaps.mean() - 1) < 0.03 and abs(gaps.std() - 1) < 0.05  # exponential: sd = mean
    counts = collections.Counter(r.frames for r in sched)
    for size, w in zip(MIX["sizes"], MIX["weights"]):
        assert abs(counts[size] / n - w) < 4 * (w * (1 - w) / n) ** 0.5
    # in blocks of 20 requests, the large requests come in bursts a fixed share would not have
    per_block = [sum(r.frames == 11 for r in sched[i:i + 20]) for i in range(0, n - 19, 20)]
    assert max(per_block) >= 4 and min(per_block) == 0


def test_a_longer_window_or_another_rate_keeps_the_realization():
    short, long = traffic.open_schedule(MIX, 10.0, 4), traffic.open_schedule(MIX, 20.0, 4)
    assert [(r.due_s, r.frames) for r in short] == [(r.due_s, r.frames) for r in long[:len(short)]]
    fast = traffic.open_schedule(dict(MIX, rate_rps=2 * MIX["rate_rps"]), 5.0, 4)
    assert [r.frames for r in fast] == [r.frames for r in short[:len(fast)]]
    assert [2 * r.due_s for r in fast] == pytest.approx([r.due_s for r in short[:len(fast)]])


def test_check_sample_takes_every_size():
    sched = traffic.open_schedule(MIX, 30.0, 5)
    picked = traffic.check_sample(sched, 3, 5)
    sizes = collections.Counter(sched[i].frames for i in picked)
    assert sizes == {s: 3 for s in MIX["sizes"]}
    assert picked == traffic.check_sample(sched, 3, 5)


def test_closed_requests():
    params = {"request_frames": 128, "pool_frames": 256}
    reqs = traffic.closed_requests(params, 9, 50)
    assert all(r.frames == 128 and 0 <= r.offset <= 128 for r in reqs)
    assert reqs == traffic.closed_requests(params, 9, 50)
