"""The program's spans and counters (utils/tracing.py): the request path's
`serve.*` spans and padding counters, the train step's `step.*` spans, and
no `record_function` at all while no profiler records."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cspn_tpu_torch import serving
from cspn_tpu_torch.models import unet
from cspn_tpu_torch.parallel.data import DataParallel
from cspn_tpu_torch.parallel.mesh import make_mesh
from cspn_tpu_torch.train import loop, state
from cspn_tpu_torch.utils import tracing

HW = (32, 48)
STEP_SPANS = ["step.optimizer", "step.forward", "step.loss", "step.backward", "step.optimizer",
              "step.metrics"]


@pytest.fixture(scope="module")
def tiny_model():
    model = unet.cspn_unet_resnet18(cspn_steps=2, generator=torch.Generator().manual_seed(0))
    return model.eval()


@pytest.fixture(scope="module")
def train_model():
    return unet.cspn_unet_resnet18(cspn_steps=2, generator=torch.Generator().manual_seed(1))


def _frames(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, *HW, 4)).astype(np.float32)


def _batch(n=2, seed=1):
    rng = np.random.default_rng(seed)
    depth = 2.0 + np.abs(rng.standard_normal((n, *HW)))
    depth[rng.random((n, *HW)) < 0.2] = 0.0
    return torch.from_numpy(_frames(n, seed)), torch.from_numpy(depth.astype(np.float32))


def _records(prof):
    """(name, start_ns, end_ns, is_annotation) of every host record."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), bool(e.is_user_annotation()))
            for e in prof.profiler.kineto_results.events()]


def _in_turn(records):
    return sorted(records, key=lambda r: r[1])


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


class _CountingRecordFunction:
    """Stands in for torch.autograd.profiler.record_function: counts and
    keeps what each construction was given, and records the real span."""

    real = torch.autograd.profiler.record_function

    def __init__(self):
        self.made = []

    def __call__(self, name, args=None):
        self.made.append((name, args))
        return self.real(name, args)


@pytest.fixture
def counting(monkeypatch):
    stub = _CountingRecordFunction()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", stub)
    return stub


def test_request_spans_nest_by_request(tiny_model, counting):
    srv = serving.DepthServer(tiny_model, buckets=(1, 8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert srv.predict(_frames(3)).shape == (3, *HW)
        assert srv.predict(_frames(11, seed=2)).shape == (11, *HW)
    recs = _records(prof)
    spans = [r for r in recs if r[3] and r[0].startswith("serve.")]
    predicts = _in_turn(r for r in spans if r[0] == "serve.predict")
    assert len(predicts) == 2
    assert all(a is None for n, a in counting.made if n.startswith("serve."))  # names alone
    for parent, b8 in zip(predicts, (1, 2)):  # 11 frames: chunk plan [8, 3], both on bucket 8
        children = _in_turn(r for r in spans if r is not parent and _inside(r, parent))
        assert [c[0] for c in children] == ["serve.h2d"] + ["serve.b8"] * b8 + ["serve.d2h"]
        assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))  # in turn, no overlap
    buckets = [r for r in spans if r[0] == "serve.b8"]
    convs = [r for r in recs if not r[3] and r[0] == "aten::convolution"]
    assert convs and all(any(_inside(c, b) for b in buckets) for c in convs)
    assert {r[0] for r in spans} == {"serve.predict", "serve.h2d", "serve.b8", "serve.d2h"}


def test_no_record_function_without_a_profiler(tiny_model, train_model, counting):
    assert torch.autograd.profiler._is_profiler_enabled is False  # the gate's flag exists
    srv = serving.DepthServer(tiny_model, buckets=(1, 8))
    step = loop.make_train_step(train_model, state.make_optimizer(train_model.parameters()), "l1")
    srv.predict(_frames(3))
    assert counting.made == []
    step(*_batch())
    assert all(n.startswith("Optimizer.") for n, _ in counting.made)  # torch.optim's own
    counting.made.clear()
    assert tracing.span("serve.predict") is tracing.span("step.forward")  # one shared no-op
    with profile(activities=[ProfilerActivity.CPU]):
        srv.predict(_frames(1))
    assert [n for n, _ in counting.made] == ["serve.predict", "serve.h2d", "serve.b1",
                                             "serve.d2h"]


@pytest.mark.parametrize("frames, computed, padded", [(3, 8, 5), (11, 16, 5), (1, 1, 0),
                                                      (16, 16, 0)])
def test_padding_counters(tiny_model, frames, computed, padded):
    srv = serving.DepthServer(tiny_model, buckets=(1, 8))
    c0, p0 = serving.computed_frames, serving.padded_frames
    srv.predict(_frames(frames))
    assert (serving.computed_frames - c0, serving.padded_frames - p0) == (computed, padded)
    srv.warmup(*HW)  # not served traffic: not counted
    assert (serving.computed_frames - c0, serving.padded_frames - p0) == (computed, padded)


@pytest.mark.parametrize("data_parallel", [False, True], ids=["model", "data_parallel"])
def test_train_step_spans_in_order(train_model, data_parallel):
    opt = state.make_optimizer(train_model.parameters())
    dp = DataParallel(train_model, make_mesh()) if data_parallel else None
    step = loop.make_train_step(train_model, opt, "l1", dp)
    batch = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("test.step"):
            loss, _ = step(*batch)
    assert torch.isfinite(loss)
    recs = _records(prof)
    outer = next(r for r in recs if r[0] == "test.step")
    spans = _in_turn(r for r in recs if r[3] and r[0].startswith("step."))
    assert [s[0] for s in spans] == STEP_SPANS
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))
    assert all(_inside(s, outer) for s in spans)
    convs = [r for r in recs if not r[3] and r[0] == "aten::convolution"]
    forward = spans[1]
    assert convs and all(_inside(c, forward) for c in convs)
