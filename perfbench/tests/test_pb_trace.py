"""The trace reduction and the per-layer readers on records made by hand."""

import types

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import trace

MS = 1_000_000  # ns


def _events():
    # window 0..100 ms; device busy 10-30 (two overlapping kernels) and 60-70;
    # the host waits 30-60 and runs a request 70-100
    return [
        (trace.WINDOW, False, 0, 100 * MS, True),
        ("perfbench.wait", False, 30 * MS, 60 * MS, True),
        ("perfbench.request", False, 70 * MS, 100 * MS, True),
        ("aten::copy_", False, 72 * MS, 99 * MS, False),
        ("void cspn2d_tiled_kernel<true>(MarchArgs)", True, 10 * MS, 25 * MS, False),
        ("sm90_xmma_gemm", True, 20 * MS, 30 * MS, False),
        ("void cspn2d_tiled_kernel<false>(MarchArgs)", True, 60 * MS, 70 * MS, False),
        ("gpu annotation", True, 0, 100 * MS, True),
        ("late kernel", True, 95 * MS, 130 * MS, False),
    ]


def test_summarize():
    s = trace.summarize(_events())
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.035)  # 10-30, 60-70, 95-100
    assert s.kernel_s["sm90_xmma_gemm"] == pytest.approx(0.01)
    assert s.kernel_s["late kernel"] == pytest.approx(0.005)
    assert s.idle_by_host["host"] == pytest.approx(0.01)  # 0-10
    assert s.idle_by_host["perfbench.wait"] == pytest.approx(0.03)
    assert s.idle_by_host["perfbench.request/aten::copy_"] == pytest.approx(0.025)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "void cspn2d_tiled_kernel<true>(MarchArgs)"


def test_readers():
    s = trace.summarize(_events())
    s.frames = 10
    cell = cells.load_cell("nyu_eval_b128")
    peaks = {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12, "fp32_flops": 67e12}
    r = types.SimpleNamespace(cell=cell, peaks=peaks, trace=s, requests=[], served={})
    idle = cells.reader("device.idle_pct.offline")(r)
    assert idle == pytest.approx(65.0)
    fwd = cell.work["conv_flops_per_frame"]["forward"]
    assert cells.reader("mfu.offline")(r) == pytest.approx(100 * fwd * 10 / 0.1 / 989e12)
    bytes_ = cell.work["cspn2d_bytes_per_frame"]["serve"] * 10
    assert cells.reader("cspn2d_tiled_roofline")(r) == pytest.approx(
        100 * bytes_ / 3.35e12 / 0.025)
    r.trace = None
    for m in cell.per_layer:
        assert cells.reader(m["name"])(r) is None


def test_serving_readers():
    cell = cells.load_cell("nyu_serve_mixed")
    reqs = [{"due": 0.0, "start": 0.002, "end": 0.01, "frames": 1, "ok": True, "traced": False},
            {"due": 0.005, "start": 0.01, "end": 0.03, "frames": 3, "ok": True, "traced": False},
            {"due": 0.03, "start": 1.5, "end": 1.6, "frames": 1, "ok": True, "traced": True}]
    r = types.SimpleNamespace(cell=cell, peaks={}, trace=None, requests=reqs,
                              served={"bf16": 1, "int8": 3})
    assert cells.reader("serve.queue_ms.open")(r) == pytest.approx(3.5)
    assert cells.reader("serve.int8_frames_pct.open")(r) == pytest.approx(75.0)


def test_kernel_kinds():
    from perfbench.harness.readers import kind

    assert kind("void cspn2d_tiled_kernel<true, (IoCode)1>(MarchArgs)") == "cspn2d_tiled"
    assert kind("void cspn2d_fwd_kernel<false>(MarchArgs)") == "cspn2d_fwd"
    for k in ("void replay_tile_kernel<true>(MarchArgs)", "reverse_tile_kernel(float const*)",
              "epilogue_kernel(float const*)"):
        assert kind(k) == "cspn2d_bwd"
    assert kind("keep_epilogue_kernel(float const*)") == "cspn2d_halo_seg"
    assert kind("void cspn3d_fwd_sweep_kernel<float>(float const*)") == "other"
