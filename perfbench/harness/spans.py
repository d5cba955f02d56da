"""What the readers of the program's own spans share (perfbench/metrics/
serve.host_stall_pct.open.py, step.host_stall_pct.train.py): the device's
idle time in the traced window by the program's span the host was in.

The program marks its stages with torch.profiler spans (cspn_tpu_torch/
utils/tracing.py: `serve.*` in DepthServer.predict, `step.*` in the train
step), which harness/trace.py reads as it reads the harness's own: a gap
of 20 us or more is labelled `<innermost span>/<innermost operator>`.  A
program without that module marks no span, and the readers return None."""

from __future__ import annotations

import sys

TRACING = "cspn_tpu_torch.utils.tracing"
# the profiler's own host operations: tracing's cost, not the program's
PROFILER_OPS = ("Activity Buffer Request", "Buffer Flush")


def host_stall_pct(r, prefixes: tuple):
    """The idle seconds of the traced window whose span (the label before
    its first `/`) starts with one of `prefixes`, less those under the
    profiler's own operations, over the window's seconds, in %."""
    t = r.trace
    if t is None or t.window_s <= 0 or TRACING not in sys.modules:
        return None
    stall = 0.0
    for label, seconds in t.idle_by_host.items():
        span, _, op = label.partition("/")
        if span.startswith(prefixes) and op not in PROFILER_OPS:
            stall += seconds
    return 100.0 * stall / t.window_s
