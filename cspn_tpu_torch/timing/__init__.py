"""The timing drivers (counterparts of the JAX package's timing scripts
under scripts/), run on the card through the hand-written kernels:

  - `latency_bench`: serving latency of the flagship model at b1, b8 and
    b32 on the bf16, int8 and int8_static paths, and the hybrid policy
    that DepthServer's `int8_from` derives from it;
  - `train_bench`: nyu_train step throughput (ResNet-50, 228x304, b16);
  - `stereo_bench`: PSMNet forward throughput with and without the 3D
    CSPN (256x512, max_disp 192, b4);
  - `stereo_train_bench`: the stereo train step's throughput;
  - `kernel_roofline`: the CSPN kernels' time against their memory
    bounds, and the 2D op split into fixed and per-step cost;
  - `loader_bench`: the data loader's frames/s from files on disk against
    the card's demand;
  - `loader_profile`: one train sample's host cost stage by stage.

Each runs as `python -m cspn_tpu_torch.timing.<module>` on `--device`
(default cuda) and writes its artifact, the JAX script's keys plus
`platform` and `card` (nvidia-smi's name and power limit; None on the
CPU), to result/torch_h100/<module>.json, or .jsonl where the JAX script
writes one JSON line a row.

The timing primitives are bench.py's: `chained` feeds each output back
into the next input, `graphed` captures a chain as one CUDA graph and
`time_call` times one replay between CUDA events.  On the CPU (the tests,
at tiny sizes) chains run eagerly under the host clock, and their numbers
are no device metric.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import torch

from cspn_tpu_torch.bench import graphed, time_call

DEFAULT_DIR = "result/torch_h100"


def default_out(name: str, lines: bool = False) -> str:
    """result/torch_h100/<name>.json, or .jsonl for an artifact of lines."""
    return os.path.join(DEFAULT_DIR, name + (".jsonl" if lines else ".json"))


def write_jsonl(path: str, rows: list[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def missing_keys(obj, schema, where: str = "") -> list[str]:
    """The keys of `schema` that `obj` lacks, as paths: a schema is a dict of
    key -> the value's schema (None: any value), or a one-item list, the
    schema of every item of a list (the JAX artifacts' keys, each
    module's JAX_KEYS)."""
    if isinstance(schema, list):
        return [m for i, item in enumerate(obj) for m in missing_keys(item, schema[0],
                                                                      f"{where}[{i}]")]
    if isinstance(schema, dict):
        if not isinstance(obj, dict):
            return [where or "."]
        return [m for k, sub in schema.items()
                for m in ([f"{where}.{k}"] if k not in obj
                          else missing_keys(obj[k], sub, f"{where}.{k}"))]
    return []


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def slope_seconds(chain, x: torch.Tensor, rng, reps_lo: int, reps_hi: int,
                  trials: int) -> tuple[float, str]:
    """(seconds a call, how it was timed): the median over `trials` of the
    two-point slope (t(reps_hi) - t(reps_lo)) / (reps_hi - reps_lo) of the
    runs of `chain(reps)` (a callable running `reps` chained calls from the
    static input `x`), so that a chain's fixed costs cancel
    (scripts/kernel_roofline.py:39-62, scripts/stereo_bench.py:66-75); x
    is nudged before every run.

    On the card each chain is one captured CUDA graph (`graphed`) timed by
    CUDA events: "graph".  Where the short chain's capture raises, both
    chains run eagerly between CUDA events: "eager".  The chains run, in
    "graph": each once eagerly (its capture's warmup), once replayed to
    warm, then `trials` times; in "eager": the short one once (the failed
    capture's warmup), then each 1 + `trials` times."""
    dev = x.device
    lo, hi = chain(reps_lo), chain(reps_hi)
    timing = "graph" if dev.type == "cuda" else "eager"
    calls = [lo, hi]
    if timing == "graph":
        try:
            calls[0] = graphed(lo, dev)
        except RuntimeError as e:
            sync(dev)
            log(f"  CUDA graph capture raised ({type(e).__name__}: {e}); timing eager chains")
            timing = "eager"
        else:
            calls[1] = graphed(hi, dev)
    for call in calls:  # warm
        x.add_(float(rng.uniform(1e-7, 1e-6)))
        call()
    slopes = []
    for _ in range(trials):
        t = []
        for call in calls:
            x.add_(float(rng.uniform(1e-7, 1e-6)))
            t.append(time_call(call, dev))
        slopes.append((t[1] - t[0]) / (reps_hi - reps_lo))
    return statistics.median(slopes), timing

