"""The readings the output check's limits are set from, for one cell, over
many seeds in one process (not run by the benchmark's own runs).

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,... [--seconds S]
        [--out chiprun_out/calibrate_<name>.jsonl]

For each seed, one line:
  - `program`: the compared numbers of a sound run of the program (a serving
    cell: a window of --seconds at the cell's own load; a training cell:
    set-up's checked steps, no window);
  - `control`: the same numbers of the control, the reference put in the
    program's place in the next precision below the configuration's (served
    frames: fp8 e4m3 where the server computes bf16, int4 where it computes
    int8; training: TF32 where the configuration states float32 with TF32
    off);
  - serving cells also `program_bf16`: the program with every bucket on its
    bf16 path (DepthServer(int8_from=None)), so that every path has a lower
    reading at the cell's own sizes, and `control_bf16`, its control (every
    sampled frame at fp8);
  - with --controls-only, a serving cell's controls alone, on the frames a
    run would sample (a closed loop taken to have served --requests);
  - training cells also `fault_half_batch`: the reference stepping on the
    first half of each batch in the program's place (the numbers of a
    state left unchanged read 1 by the measure and need no run).
The last line holds, for every number, the largest program reading and the
smallest control and fault readings.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # the checkout, in place of this script's directory
    sys.path[0] = str(ROOT)

from perfbench.harness import env  # noqa: E402

env.set_cache_dirs(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import run  # noqa: E402
from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness import weights  # noqa: E402

# the control of each numeric path: the next precision below it
CONTROL = {"bf16": "fp8", "int8": "int4"}


def _control(ctx, rows, path_of) -> dict:
    """The control's numbers on the sampled frames: the reference in fp8
    where the server computes bf16, in int4 where it computes int8."""
    cfg, device, seed = ctx.cell.config, ctx.device, ctx.seed
    w0 = weights.make(cfg["arch"], seed, device, cfg["in_channels"])
    served = torch.empty((len(rows), *cfg["frame"]))
    for path, quant in CONTROL.items():
        idx = [i for i, p in enumerate(path_of) if p == path]
        if idx:
            served[idx] = ctx.system.reference_serve(cfg, w0, rows[idx], device, quant=quant)
    return cells.driver("serve", ROOT).compare(ctx, rows, served, path_of)


def default_paths(sizes) -> dict:
    """The path DepthServer's defaults route each request size to, read off
    its own routing without building models."""
    import inspect
    import types

    from cspn_tpu_torch.serving import DepthServer, chunk_plan, pick_bucket

    sig = inspect.signature(DepthServer.__init__).parameters
    buckets, int8_from = sig["buckets"].default, sig["int8_from"].default
    stub = types.SimpleNamespace(models={"int8": object()}, int8_from=int8_from)
    out = {}
    for n in sizes:
        paths = {DepthServer.path_for(stub, pick_bucket(c, buckets)) for c in chunk_plan(n, buckets)}
        out[n] = "int8" if "int8" in paths else "bf16"
    return out


def sampled_rows(cell, seed: int, seconds: float, device, requests: int):
    """The frames a run's output check would sample, without running the
    program (a closed loop taken to have served `requests` requests), and
    the path of each by the server's default routing."""
    from perfbench.harness import data, traffic

    cfg, tr = cell.config, cell.traffic
    pool = data.frames(tr["pool_frames"], *cfg["frame"], cfg["n_sample"],
                       data.generator(seed, data.POOL, device), device)[0].cpu().numpy()
    if tr["loop"] == "open":
        reqs = traffic.open_schedule(tr, seconds, seed)
        picked = [reqs[i] for i in sorted(traffic.check_sample(reqs, tr["check_per_size"], seed))]
        spans = [(r.offset, r.frames, r.frames) for r in picked]
    else:
        reqs = traffic.closed_requests(tr, seed, requests)
        rng = np.random.default_rng([seed, 2])
        kept = [(r.offset + int(rng.integers(r.frames)), 1, r.frames) for r in reqs]
        pick = np.random.default_rng([seed, 3]).choice(
            len(kept), size=min(tr["check_frames"], len(kept)), replace=False)
        spans = [kept[i] for i in sorted(pick.tolist())]
    paths = default_paths({size for _, _, size in spans})
    rows = np.concatenate([pool[lo:lo + n] for lo, n, _ in spans])
    path_of = [paths[size] for _, n, size in spans for _ in range(n)]
    return rows, path_of


def serve_readings(cell, seed: int, seconds: float, device, program: bool = True,
                   requests: int = 120) -> dict:
    drv = cells.driver("serve", ROOT)
    out = {}
    ctx = run.context(cell, seed, seconds, False, device, time.monotonic())
    if program:
        for key, kw in (("program", {}), ("program_bf16", {"int8_from": None})):
            ctx = run.context(cell, seed, seconds, False, device, time.monotonic())
            ctx.server_kw = kw
            res = drv.run(ctx)
            out[key] = res["readings"]["numbers"]
            if key == "program":
                rows, path_of = res["readings"]["checked"]
    else:
        rows, path_of = sampled_rows(cell, seed, seconds, device, requests)
    out["control"] = _control(ctx, rows, path_of)
    # with every bucket on bf16 (program_bf16's routing), every frame's control is fp8
    out["control_bf16"] = _control(ctx, rows, ["bf16"] * len(rows))
    return out


def train_readings(cell, seed: int, device) -> dict:
    drv = cells.driver("train", ROOT)
    ctx = run.context(cell, seed, 0.0, False, device, time.monotonic())
    res = drv.run(ctx)
    out = {"program": res["readings"]["numbers"]}
    cfg, tr = cell.config, cell.traffic
    batches = drv._batches(cfg, tr, seed, device)[: tr["checked_steps"]]
    for key, kw in (("control", {"tf32": True}), ("fault_half_batch", {"half_batch": True})):
        w0 = weights.make(cfg["arch"], seed, device, cfg["in_channels"])
        losses, first, p = ctx.system.reference_train(cfg, w0, batches, device, **kw)
        with torch.no_grad():
            g1 = {k: float(v.norm()) for k, v in first.items()}
            change = {k: float((p[k] - w0[k]).norm()) for k in p}
        del w0, first, p
        out[key] = drv.compare(ctx, batches, losses, g1, change)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    ap.add_argument("--controls-only", action="store_true")
    ap.add_argument("--requests", type=int, default=120)
    args = ap.parse_args()
    cell = cells.load_cell(args.workload, root=ROOT)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if device.type == "cuda":
        from cspn_tpu_torch.ops import _build

        _build.build()
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            r = train_readings(cell, seed, device)
        else:
            r = serve_readings(cell, seed, args.seconds, device, not args.controls_only,
                               args.requests)
        r.update(seed=seed, seconds=time.perf_counter() - t0)
        lines.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seeds": len(lines)}
    for key in ("program", "program_bf16"):
        for name in {n for r in lines for n in r.get(key, {})}:
            summary.setdefault("lower", {})[name] = max(
                [summary.get("lower", {}).get(name, 0.0)] + [r[key][name] for r in lines
                                                              if name in r.get(key, {})])
    for key in ("control", "control_bf16", "fault_half_batch"):
        for name in {n for r in lines for n in r.get(key, {})}:
            summary.setdefault(key, {})[name] = min(r[key][name] for r in lines
                                                    if name in r.get(key, {}))
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in lines + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
