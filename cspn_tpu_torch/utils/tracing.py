"""Named spans of the program, on the device trace's clock.

`span(name)` is a `record_function` while a torch.profiler session
records, so the span lands in the same kineto record stream as the card's
kernels and copies and a trace can say which stage of the program the
card waited for; with no session recording it is one shared no-op context
(a bare `record_function` costs ~15 us a span on a CPU host, the check
well under one).

The spans (a fixed set, no `/` in a name, so that a trace's reduction can
sum them by name):

  - serving.py:DepthServer.predict: `serve.predict`, and inside it (a
    request's spans are the ones its `serve.predict` holds) `serve.h2d`,
    one `serve.b<bucket>` a chunk (copy into the static input, pad rows,
    replay or eager forward, clone) and `serve.d2h`;
  - train/loop.py:make_train_step: `step.optimizer` (the zero_grad at the
    top, then optimizer.step), `step.forward`, `step.loss`, `step.backward`,
    `step.metrics`; `step.h2d` around Trainer's host-to-device copy.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler span named `name` while torch.profiler records, else a
    shared no-op context."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.autograd.profiler.record_function(name)
    return _OFF
