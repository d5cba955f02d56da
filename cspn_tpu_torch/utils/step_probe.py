"""The CSPN step-body probe on the card (counterpart of scripts/vpu_probe.py):
is bf16 arithmetic, or bf16 gate storage, faster than f32 for the 2D CSPN
stencil's inner loop?

    python -m cspn_tpu_torch.utils.step_probe [--iters-lo 1024] [--iters-hi 8192]
        [--trials 7] [--out FILE.json]

The kernel (csrc/step_probe.cu, its header says what it computes and what
bounds it) runs the TPU probe's loop body `iters` times, all on chip, on one
[8,512] block of gates and state per SM: 8 products of distinct gate planes
against rows dy in {-1, 0, 1}, the two column shifts of the partial sums
with zero fill, and the x 0.124 rescale.  The TPU probe's block is one
[256,512] state; its 8 f32 gate planes (4 MB) do not fit one SM, so the
port's block is [8,512] and every SM runs its own.  For each dtype pair
(gates / state: f32 / f32, bf16 / f32, bf16 / bf16) the time of one
iteration is the two-point slope between `iters_hi` and `iters_lo`
(CUDA events, median over `trials`), reported as ns per iteration, ps per
pixel-iteration and Tops/s under the TPU probe's count of 19 operations
per pixel per iteration (vpu_probe.py:107).  Prints one JSON line per
pair, with the card's name and power limit.

`step_probe` is the kernel's wrapper: a tensor on the CPU goes to its plain
version `step_probe_ref` because it lies on the CPU, a CUDA tensor to the
kernel, which raises if it fails.  `launches` counts its launches.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

ROWS, COLS = 8, 512  # one block: csrc/step_probe.cu kRows, kCols
SCALE = 0.124
OPS_PER_PX_ITER = 19  # the TPU probe's count for its Tops/s: 8 mul + 7 add + 2 shifts + 2 scale
# the f32 work an iteration needs per pixel, for its bound: 8 products, 7
# adds and one x 0.124 (the column shifts are shuffles, not arithmetic)
FLOPS_PER_PX_ITER = 16
PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
         (torch.bfloat16, torch.bfloat16))

launches = 0


def probe_inputs(blocks: int, gate_dtype, state_dtype, device="cpu", seed: int = 0):
    """Gates [blocks,8,8,512] in [0.9, 1.1) and state [blocks,8,512] in
    [0.5, 1.5), as the TPU probe draws them, from a seeded generator."""
    gen = torch.Generator(device).manual_seed(seed)
    g = 0.9 + 0.2 * torch.rand(blocks, 8, ROWS, COLS, generator=gen, device=device)
    x = 0.5 + torch.rand(blocks, ROWS, COLS, generator=gen, device=device)
    return g.to(gate_dtype), x.to(state_dtype)


def _shift(t: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    """y[..., i, ...] = t[..., i + off, ...] along `dim`, zero fill."""
    n = t.shape[dim]
    zeros = torch.zeros_like(t.narrow(dim, 0, abs(off)))
    if off > 0:
        return torch.cat([t.narrow(dim, off, n - off), zeros], dim)
    return torch.cat([zeros, t.narrow(dim, 0, n + off)], dim)


def step_probe_ref(g: torch.Tensor, x: torch.Tensor, iters: int) -> torch.Tensor:
    """The kernel's plain version: `iters` probe iterations on each block,
    in the state's dtype (bf16 gates upcast at use under f32 state), each
    product after the first of a sum fused into its add (torch.addcmul),
    as the kernel's FMAs.  g [B,8,8,512] in reference gate order, x
    [B,8,512]."""
    g = g.to(x.dtype)
    scale = torch.tensor(SCALE, dtype=x.dtype, device=x.device)  # bf16(0.124) under bf16
    for _ in range(iters):
        xp, xm = _shift(x, 1, -2), _shift(x, -1, -2)  # rows i + 1, i - 1
        u1 = torch.addcmul(torch.addcmul(g[:, 0] * xp, g[:, 3], x), g[:, 5], xm)
        u0 = torch.addcmul(g[:, 1] * xp, g[:, 6], xm)
        um1 = torch.addcmul(torch.addcmul(g[:, 2] * xp, g[:, 4], x), g[:, 7], xm)
        x = (u0 + _shift(u1, 1, -1) + _shift(um1, -1, -1)) * scale
    return x


def _check_inputs(g, x):
    pair = (g.dtype, x.dtype)
    if pair not in PAIRS:
        raise TypeError(f"gate/state dtypes {pair} not among {PAIRS}")
    b = x.shape[0]
    if tuple(g.shape) != (b, 8, ROWS, COLS) or tuple(x.shape) != (b, ROWS, COLS):
        raise ValueError(f"g must be [B,8,{ROWS},{COLS}] and x [B,{ROWS},{COLS}], got "
                         f"{tuple(g.shape)}, {tuple(x.shape)}")
    if g.device != x.device or not (g.is_contiguous() and x.is_contiguous()):
        raise ValueError("g and x must be contiguous, on one device")


def _launch(g, x, iters: int) -> torch.Tensor:
    global launches
    from cspn_tpu_torch.ops import _build

    lib = _build.load("step_probe")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.step_probe(g.data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0], int(iters),
                             int(g.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
                             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"step_probe launch failed: cudaError_t {err}")
    launches += 1
    return out


def step_probe(g: torch.Tensor, x: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` probe iterations on each [8,512] block: the kernel on CUDA
    tensors, `step_probe_ref` on CPU ones."""
    _check_inputs(g, x)
    if x.device.type == "cpu":
        return step_probe_ref(g, x, iters)
    return _launch(g, x, iters)


def measure(gate_dtype, state_dtype, blocks: int, iters_lo: int, iters_hi: int,
            trials: int = 7) -> dict:
    """One dtype pair's time per iteration: the two-point slope of CUDA
    event times of one launch at `iters_hi` and at `iters_lo`, median over
    `trials`, after a warm-up of both."""
    g, x = probe_inputs(blocks, gate_dtype, state_dtype, device="cuda")

    def timed(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _launch(g, x, iters)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    timed(iters_lo), timed(iters_hi)
    slopes = []
    for _ in range(trials):
        t_lo, t_hi = timed(iters_lo), timed(iters_hi)
        slopes.append((t_hi - t_lo) / (iters_hi - iters_lo))
    per_iter = statistics.median(slopes)
    px = blocks * ROWS * COLS
    return {
        "gate_dtype": str(gate_dtype).removeprefix("torch."),
        "state_dtype": str(state_dtype).removeprefix("torch."),
        "blocks": blocks,
        "ns_per_iter": per_iter * 1e9,
        "ps_per_px_iter": per_iter / px * 1e12,
        "Tops_per_s": OPS_PER_PX_ITER * px / per_iter / 1e12,
    }


def run_probe(iters_lo: int = 1024, iters_hi: int = 8192, trials: int = 7) -> list[dict]:
    """`measure` for every dtype pair on the current card, one block per SM."""
    if not torch.cuda.is_available():
        raise RuntimeError("the step probe measures the card: torch.cuda.is_available() is False")
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    return [measure(gd, sd, blocks, iters_lo, iters_hi, trials) for gd, sd in PAIRS]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.utils.step_probe")
    p.add_argument("--iters-lo", type=int, default=1024)
    p.add_argument("--iters-hi", type=int, default=8192)
    p.add_argument("--trials", type=int, default=7)
    p.add_argument("--out", default=None, help="write the results here as JSON")
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = run_probe(args.iters_lo, args.iters_hi, args.trials)
    print(card, flush=True)
    for r in results:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
