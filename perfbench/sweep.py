"""One sweep of an open-loop serving cell's offered rate, to find the knee
(not run by the benchmark's own runs; the cell's rate is then fixed in its
traffic file).

    python3 perfbench/sweep.py --workload <name> --rates 40,60,80 --seconds 15 --seed <n>

For each rate, one line: the offered requests and frames a second, the
served frames a second, the latency's median, 95th and 99th percentiles,
and the mean wait of the first and of the last tenth of the requests (a
backlog that grows through the window shows as a last tenth that waits
far longer than the first).
"""

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # the checkout, in place of this script's directory
    sys.path[0] = str(ROOT)

from perfbench.harness import env  # noqa: E402

env.set_cache_dirs(ROOT)

import torch  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness import traffic  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    base = cells.load_cell(args.workload, root=ROOT)
    device = torch.device("cuda", 0)
    from cspn_tpu_torch.ops import _build

    _build.build()
    drv = cells.driver("serve", ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = dataclasses.replace(base, traffic=dict(base.traffic, rate_rps=rate))
        res = drv.run(run.context(cell, args.seed, args.seconds, False, device, time.monotonic()))
        recs = res["readings"]["requests"]
        lat = [(r["end"] - r["due"]) * 1e3 for r in recs]
        tenth = max(len(recs) // 10, 1)
        wait = [(r["start"] - r["due"]) * 1e3 for r in recs]
        frames = sum(r["frames"] for r in recs)
        print(json.dumps({
            "rate_rps": rate, "requests": len(recs), "offered_frames_per_s": frames / args.seconds,
            "served_frames_per_s": res["metrics"]["serve_frames_per_s"],
            "p50_ms": traffic.percentile(lat, 50), "p95_ms": traffic.percentile(lat, 95),
            "p99_ms": traffic.percentile(lat, 99),
            "wait_first_tenth_ms": sum(wait[:tenth]) / tenth,
            "wait_last_tenth_ms": sum(wait[-tenth:]) / tenth,
            "failed": res["failed"], "int8_frames": res["readings"]["served"].get("int8"),
            "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
