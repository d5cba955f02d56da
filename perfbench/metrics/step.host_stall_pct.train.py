"""step.host_stall_pct.train: the share, in %, of the traced window in which
the device was idle while the host was inside one of the train step's
spans (`step.forward`, `step.loss`, `step.backward`, `step.optimizer`,
`step.metrics`; the innermost at the middle of each idle gap of 20 us or
more), less the profiler's own buffer operations (harness/spans.py).
torch.optim marks its own `Optimizer.step#SGD.step` and
`Optimizer.zero_grad#SGD.zero_grad`, which lie inside `step.optimizer`
and, being innermost, label its gaps: they count as the step's."""

from perfbench.harness.spans import host_stall_pct


def read(r):
    return host_stall_pct(r, ("step.", "Optimizer."))
