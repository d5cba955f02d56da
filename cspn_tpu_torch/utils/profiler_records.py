"""How complete torch.profiler's records of the port's kernel launches are:
the card's kernel records against the host's cudaLaunch* records, session
by session.

    python -m cspn_tpu_torch.utils.profiler_records [--sessions 500]

On the card it profiles the sharded segment's backward
(ops/cspn_halo_cuda.py: 4 CUDA launches a call at K = 13 with keep, on a
[3,8,61,90] block) in `--sessions` sessions of each kind: 1 call or 5
calls a session, each with and without a 2 ms pause between the session's
start and the first call.  For each kind it prints one JSON line: the
sessions whose kernel records fall short of the launches made, how many
of those lost the session's first kernels (and no other), and the
sessions whose host launch records do.  chip_smoke.py:kernel_profile
holds the host's count because of what this shows (PERF.md §6).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

KINDS = ((1, 0.0), (1, 0.002), (5, 0.0), (5, 0.002))  # (calls a session, pause s)
SHAPE, K = (3, 61, 90), 13
ORDER = ("replay", "reverse", "reverse", "epilogue")  # one call's launches at K = 13


def _kernel(name: str) -> str:
    return next(k for k in ORDER if f"halo_seg_{k}" in name or f"keep_{k}" in name)


def session_records(fn, calls: int, pause: float) -> tuple[list[str], int]:
    """One session of `calls` calls of `fn`: the card's kernel records in
    the order they ran, and the host's kernel launch records."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if pause:
            time.sleep(pause)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))),
                     key=lambda e: e.time_range.start)
    host = sum(e.count for e in prof.key_averages() if e.key.startswith(("cudaLaunch", "cuLaunch")))
    return [_kernel(e.name) for e in kernels], host


def run(sessions: int) -> list[dict]:
    from cspn_tpu_torch.ops import cspn_halo_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, he, w = SHAPE
    gates = torch.randn(n, 8, he, w, device="cuda", generator=gen) / 4
    base, x, ct = (torch.randn(n, he, w, device="cuda", generator=gen) for _ in range(3))
    keep = 1.0 - (torch.rand(n, he, w, device="cuda", generator=gen) < 0.2).float()

    def fn():
        cspn_halo_cuda._launch_bwd(gates, base, keep, x, ct, K)

    fn()
    torch.cuda.synchronize()
    assert cspn_halo_cuda.cuda_launches(K, True)[1] == len(ORDER)
    rows = []
    for calls, pause in KINDS:
        full = list(ORDER) * calls
        short = first = host_short = 0
        for _ in range(sessions):
            kernels, host = session_records(fn, calls, pause)
            host_short += host < len(full)
            if len(kernels) < len(full):
                short += 1
                first += kernels == full[len(full) - len(kernels):]
        rows.append({"calls_a_session": calls, "pause_s": pause, "sessions": sessions,
                     "kernel_records_short": short, "of_which_the_first_lost": first,
                     "host_records_short": host_short})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.utils.profiler_records")
    p.add_argument("--sessions", type=int, default=500)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_records measures the card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rows = run(args.sessions)
    print(card, flush=True)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
