"""serve.queue_ms.open: the mean wait, in ms, of the served requests from
the time each was due to the start of its `predict` (the harness's host
clock), over every request the window sent before the profiler started
(the first `trace_at` of it): the profiler's start can stall the host for
a second, which would be read as queueing."""


def read(r):
    waits = [q["start"] - q["due"] for q in r.requests if q["ok"] and not q["traced"]]
    return 1e3 * sum(waits) / len(waits) if waits else None
