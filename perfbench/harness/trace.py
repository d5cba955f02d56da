"""The traced part of a `--trace 1` run, reduced to what the per-layer
readers and the result line need.

`Tracer.start()` synchronizes the device and starts torch.profiler (CPU
and CUDA activities), `Tracer.open()` opens the traced window (an open
loop opens it once the first request under the profiler has returned:
the profiler's first records can stall the host for a second or more,
which is the profiler's and not the server's idle time; a train step's
window opens after the first traced step, for the same reason); the harness marks
its own spans with `record_function` ("perfbench.wait" between requests,
"perfbench.request", "perfbench.step"); `Tracer.stop()` synchronizes,
closes the window and stops.  The window's length is the profiler's clock
between its opening and its close.  From the device records it takes:

  - `busy_s`: the length of the union of every device operation's
    interval (kernels, copies, sets) inside the window;
  - `kernel_s`: device seconds by kernel name;
  - `idle_by_host`: the seconds the device was idle inside the window,
    split by what the host was doing at the middle of each gap of 20 us
    or more: the innermost harness span and the innermost operator under
    it; the shorter gaps summed under one label.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

WINDOW = "perfbench.window"
# gaps shorter than this (between the kernels of one launch sequence) are
# summed under one label instead of being matched to host spans
SHORT_GAP_NS = 20_000
SHORT_GAP = "gaps under 20 us"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict
    idle_by_host: dict
    frames: int = 0  # frames the harness completed inside the window

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _events(prof):
    """(name, is_device, start_ns, end_ns, is_annotation) of every record."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        out.append((e.name(), dev, e.start_ns(), e.start_ns() + e.duration_ns(),
                    bool(e.is_user_annotation())))
    return out


def summarize(events) -> TraceSummary:
    win = [(s, t) for name, dev, s, t, _ in events if name == WINDOW and not dev]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0]
    device, host = [], []
    for name, dev, s, t, ann in events:
        if dev and not ann:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                device.append((s, t, name))
        elif not dev and name != WINDOW:
            host.append((s, t, name, ann))
    kernel_s: dict = collections.Counter()
    for s, t, name in device:
        kernel_s[name] += (t - s) / 1e9
    # the union of the device intervals, and the gaps between them
    busy, gaps, end = 0, [], w0
    for s, t, _ in sorted(device):
        if s > end:
            gaps.append((end, s))
        if t > end:
            busy += t - max(s, end)
            end = t
    if w1 > end:
        gaps.append((end, w1))
    idle: dict = collections.Counter()
    spans = sorted(host)
    starts = [s for s, _, _, _ in spans]
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_NS:
            idle[SHORT_GAP] += (g1 - g0) / 1e9
            continue
        mid = (g0 + g1) / 2
        live = [x for x in spans[:bisect.bisect_right(starts, mid)] if mid < x[1]]
        span = min((x for x in live if x[3]), key=lambda x: x[1] - x[0], default=None)
        op = min((x for x in live if not x[3]), key=lambda x: x[1] - x[0], default=None)
        label = (span[2] if span else "host") + (f"/{op[2]}" if op else "")
        idle[label] += (g1 - g0) / 1e9
    return TraceSummary((w1 - w0) / 1e9, busy / 1e9, dict(kernel_s), dict(idle))


class Tracer:
    """A profiler over one part of the window (see the module docstring)."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.mark = None
        self.active = False
        self.frames = 0

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up, so that its first
        start (CUPTI's initialization) falls outside the window."""
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, window: bool = True) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof = self._profile()
        self.prof.__enter__()
        self.active = True
        if window:
            self.open()

    def open(self) -> None:
        self.mark = torch.autograd.profiler.record_function(WINDOW)
        self.mark.__enter__()
        self.frames = 0

    def stop(self, frames: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.mark is None:  # nothing returned under the profiler: an empty window
            self.open()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False
        self.frames = frames

    def finish(self) -> TraceSummary | None:
        """The summary of the traced part, reduced once the window has
        closed (the reduction takes seconds, which the window must not)."""
        if self.prof is None or self.active:
            return None
        summary = summarize(_events(self.prof))
        summary.frames = self.frames
        self.prof = None
        return summary


def span(name: str):
    return torch.autograd.profiler.record_function(name)
