"""serve.pad_frames_pct.open: the share, in %, of the frames the server's
bucket forwards computed that were padding (cspn_tpu_torch.serving's
`padded_frames` over `computed_frames`, read at the run's end: set-up's
first request of each size included).  None without a trace, or where the
program keeps no such counters."""

import sys


def read(r):
    serving = sys.modules.get("cspn_tpu_torch.serving")
    computed = getattr(serving, "computed_frames", 0)
    if r.trace is None or not computed:
        return None
    return 100.0 * serving.padded_frames / computed
