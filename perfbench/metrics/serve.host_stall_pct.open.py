"""serve.host_stall_pct.open: the share, in %, of the traced window in which
the device was idle while the host was inside one of the server's spans
(`serve.predict`, `serve.h2d`, `serve.b<bucket>`, `serve.d2h`; the
innermost at the middle of each idle gap of 20 us or more), less the
profiler's own buffer operations (harness/spans.py)."""

from perfbench.harness.spans import host_stall_pct


def read(r):
    return host_stall_pct(r, ("serve.",))
