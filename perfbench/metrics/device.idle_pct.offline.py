"""device.idle_pct.offline: the share, in %, of the traced window in which no
operation ran on the device (torch.profiler's device records)."""

from perfbench.harness.readers import idle_pct as read  # noqa: F401
