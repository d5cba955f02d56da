"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (cspn_tpu_torch)
beside BENCHMARK.json and perfbench/.  The cell's files are found by name
(harness/cell.py); its traffic kind's driver (drivers/<kind>.py) makes the
inputs and weights from --seed, builds the program under test and warms
every shape the traffic uses (all of which counts as `setup_s`, from the
start of this process), measures for --seconds, then checks the outputs
against the plain reference once the program's state is freed.

--trace 0 reports the cell's end-to-end metrics; --trace 1 traces part of
the window with torch.profiler and reports its per-layer metrics, each
read by perfbench/metrics/<metric>.py, with `busy_s`, `window_s` and a
`breakdown` of the trace.  The compared numbers and their limits are the
last lines on stderr and the last key of the result line, which is the
last line on stdout.  Exits non-zero without a result where there is no
CUDA device (or fewer than the cell asks for), where the program cannot
be imported, or where JAX or the JAX package is loaded once the window
has closed.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # the checkout, in place of this script's directory
    sys.path[0] = str(ROOT)

from perfbench.harness import env  # noqa: E402

env.set_cache_dirs(ROOT)

from perfbench.harness import cell as cells  # noqa: E402


def context(cell, seed: int, seconds: float, trace: bool, device, t_process: float):
    import torch

    return types.SimpleNamespace(
        cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, t_process=t_process,
        system=cells.system(cell.config["system"], ROOT), log=env.log,
        stage=lambda what: env.log(f"# setup: {what} at {time.monotonic() - t_process:.2f} s"),
        device_fields=lambda: env.device_fields(torch, device))


def per_layer(cell, result: dict, peaks: dict) -> dict:
    r = types.SimpleNamespace(cell=cell, peaks=peaks, **result["readings"])
    out = {}
    for m in cell.per_layer:
        value = cells.reader(m["name"], ROOT)(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_process: float) -> dict:
    """The result line of one run (without the purity check)."""
    result = cells.driver(cell.traffic["kind"], ROOT).run(
        context(cell, seed, seconds, trace, device, t_process))
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        summary = result["readings"]["trace"]
        if summary is None:
            raise RuntimeError("the window ended before its traced part began")
        metrics = per_layer(cell, result, env.peaks(result["device"]["kind"])
                            if device.type == "cuda" else {})
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in result["metrics"].items()
                   if k in units}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": result["device"]}
    if trace:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cell = cells.load_cell(args.workload, root=ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        env.log(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
                f"available: {torch.cuda.is_available()}, count {torch.cuda.device_count()}")
        return 2
    import cspn_tpu_torch  # noqa: F401  the program must be present
    from cspn_tpu_torch.ops import _build

    env.log(f"# setup: imported at {time.monotonic() - T_PROCESS:.2f} s")
    _build.build()  # the program's kernels: built in the first run of a checkout, reused after
    env.log(f"# setup: kernels loaded at {time.monotonic() - T_PROCESS:.2f} s")
    device = torch.device("cuda", 0)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS)
    bad = env.forbidden_modules()
    if bad:
        env.log(f"perfbench: forbidden modules loaded: {bad}")
        return 3
    for name, c in line["checks"].items():
        env.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
