"""The readers of the program's own spans and counters (harness/spans.py,
serve.pad_frames_pct.open, serve.host_stall_pct.open,
step.host_stall_pct.train) on records made by hand, shaped as
test_pb_trace.py's."""

import sys
import types

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import spans, trace, traffic

MS = 1_000_000  # ns


def _serve_events():
    # window 0..100 ms; the program's spans inside the harness's request;
    # the device idle 11-19 (h2d copy), 21-31 (graph launch), 34-46 (the
    # profiler's buffer request), 51-59 (d2h copy) and 70-80 (the wait)
    return [
        (trace.WINDOW, False, 0, 100 * MS, True),
        ("perfbench.request", False, 10 * MS, 61 * MS, True),
        ("serve.predict", False, 10 * MS, 60 * MS, True),
        ("serve.h2d", False, 10 * MS, 20 * MS, True),
        ("cudaMemcpyAsync", False, 12 * MS, 18 * MS, False),
        ("serve.b8", False, 20 * MS, 50 * MS, True),
        ("cudaGraphLaunch", False, 22 * MS, 30 * MS, False),
        ("Activity Buffer Request", False, 35 * MS, 45 * MS, False),
        ("serve.d2h", False, 50 * MS, 60 * MS, True),
        ("cudaMemcpyAsync", False, 52 * MS, 58 * MS, False),
        ("perfbench.wait", False, 65 * MS, 85 * MS, True),
        ("k0", True, 0, 11 * MS, False),
        ("k1", True, 19 * MS, 21 * MS, False),
        ("k2", True, 31 * MS, 34 * MS, False),
        ("k3", True, 46 * MS, 51 * MS, False),
        ("k4", True, 59 * MS, 70 * MS, False),
        ("k5", True, 80 * MS, 100 * MS, False),
    ]


def _step_events():
    # window 0..100 ms; the step's spans inside the harness's step; the
    # device idle 1-2 (the harness's own), 30-35 (forward, no operator),
    # 55-65 (backward), 91-93 (torch.optim's own span inside the step's),
    # 95-100 (the profiler's buffer flush)
    return [
        (trace.WINDOW, False, 0, 100 * MS, True),
        ("perfbench.step", False, 0, 100 * MS, True),
        ("step.forward", False, 2 * MS, 40 * MS, True),
        ("step.backward", False, 40 * MS, 90 * MS, True),
        ("aten::convolution_backward", False, 50 * MS, 70 * MS, False),
        ("step.optimizer", False, 90 * MS, 100 * MS, True),
        ("Optimizer.step#SGD.step", False, 90 * MS, 94 * MS, True),
        ("Buffer Flush", False, 96 * MS, 99 * MS, False),
        ("k0", True, 0, 1 * MS, False),
        ("k1", True, 2 * MS, 30 * MS, False),
        ("k2", True, 35 * MS, 55 * MS, False),
        ("k3", True, 65 * MS, 91 * MS, False),
        ("k4", True, 93 * MS, 95 * MS, False),
    ]


def _readings(events, **kw):
    return types.SimpleNamespace(trace=trace.summarize(events), peaks={}, requests=[],
                                 served={}, **kw)


@pytest.fixture
def traced_program(monkeypatch):
    """A program that marks its spans (its tracing module is loaded)."""
    monkeypatch.setitem(sys.modules, spans.TRACING, types.ModuleType(spans.TRACING))


def test_serve_host_stall_by_program_span(traced_program):
    r = _readings(_serve_events(), cell=cells.load_cell("nyu_serve_mixed"))
    gaps = r.trace.idle_by_host
    assert gaps["serve.h2d/cudaMemcpyAsync"] == pytest.approx(0.008)
    assert gaps["serve.b8/cudaGraphLaunch"] == pytest.approx(0.010)
    assert gaps["serve.b8/Activity Buffer Request"] == pytest.approx(0.012)
    assert gaps["serve.d2h/cudaMemcpyAsync"] == pytest.approx(0.008)
    assert cells.reader("device.idle_pct.open")(r) == pytest.approx(48.0)
    # the buffer request and the wait are not the program's
    assert cells.reader("serve.host_stall_pct.open")(r) == pytest.approx(26.0)
    assert cells.reader("step.host_stall_pct.train")(r) == pytest.approx(0.0)


def test_step_host_stall_by_program_span(traced_program):
    r = _readings(_step_events(), cell=cells.load_cell("kitti_train_b4"))
    gaps = r.trace.idle_by_host
    assert gaps["perfbench.step"] == pytest.approx(0.001)
    assert gaps["step.forward"] == pytest.approx(0.005)
    assert gaps["step.backward/aten::convolution_backward"] == pytest.approx(0.010)
    assert gaps["Optimizer.step#SGD.step"] == pytest.approx(0.002)
    assert gaps["step.optimizer/Buffer Flush"] == pytest.approx(0.005)
    assert cells.reader("device.idle_pct.train")(r) == pytest.approx(23.0)
    assert cells.reader("step.host_stall_pct.train")(r) == pytest.approx(17.0)


def test_span_readers_read_nothing_without_a_trace_or_the_program_s_spans(
        traced_program, monkeypatch):
    for name, events in (("serve.host_stall_pct.open", _serve_events()),
                         ("step.host_stall_pct.train", _step_events())):
        r = _readings(events)
        assert cells.reader(name)(r) is not None
        r.trace = None
        assert cells.reader(name)(r) is None
        r = _readings(events)
        monkeypatch.delitem(sys.modules, spans.TRACING)  # a program without spans
        assert cells.reader(name)(r) is None
        monkeypatch.setitem(sys.modules, spans.TRACING, types.ModuleType(spans.TRACING))


def test_pad_frames_reader(monkeypatch):
    read = cells.reader("serve.pad_frames_pct.open")
    r = _readings(_serve_events())
    program = types.SimpleNamespace(computed_frames=7204, padded_frames=3286)
    monkeypatch.setitem(sys.modules, "cspn_tpu_torch.serving", program)
    assert read(r) == pytest.approx(100 * 3286 / 7204)
    program.computed_frames = 0  # nothing served
    assert read(r) is None
    monkeypatch.setitem(sys.modules, "cspn_tpu_torch.serving", types.SimpleNamespace())
    assert read(r) is None  # a program without the counters
    monkeypatch.delitem(sys.modules, "cspn_tpu_torch.serving")
    assert read(r) is None
    monkeypatch.setitem(sys.modules, "cspn_tpu_torch.serving", program)
    program.computed_frames = 7204
    r.trace = None
    assert read(r) is None


def test_the_open_cell_pads_its_fixed_realization_by_45_6_pct():
    """The open cell's requests, and set-up's first request of each size,
    through the server's buckets and chunk plan: the share that
    serve.pad_frames_pct.open reads on every seed."""
    from cspn_tpu_torch.serving import chunk_plan, pick_bucket

    cell = cells.load_cell("nyu_serve_mixed")
    reqs = traffic.open_schedule(cell.traffic, 30, 2147483659)
    sizes = [r.frames for r in reqs] + sorted({r.frames for r in reqs})
    buckets = (1, 8, 32, 128)  # load_server's
    computed = sum(pick_bucket(n, buckets) for s in sizes for n in chunk_plan(s, buckets))
    assert (len(reqs), sum(sizes)) == (1429, 3895 + 23)
    assert 100 * (computed - sum(sizes)) / computed == pytest.approx(45.6, abs=0.05)
