"""The CSPN ops against their memory bounds on the card (counterpart of
scripts/kernel_roofline.py).

Each probe times one op call as the two-point slope between chains of
`reps_lo` and `reps_hi` calls, each output fed back into the next input,
the median of `trials` (timing/__init__.py:slope_seconds: one captured
CUDA graph a chain, CUDA events), under inference mode, where the ops take
the routes that no backward follows:

  - `probe_2d`: ops/cspn.py:cspn2d on [N, 8, H, W] guidance (the port's
    layout, as CSPNUNet hands it), blur and ~1% sparse samples: the tiled
    kernel `cspn2d_tiled` (PERF.md row 3); with `io_dtype` bfloat16 the
    row feeds what the bf16 model hands the CSPN, bf16 guidance and blur
    and the float32 sparse map, which the kernel rounds to bf16 as it
    loads it (csrc/cspn2d_tiled.cu:cspn2d_tiled_io); the chain's feedback
    then casts the next blur to bf16 (one plane);
  - `probe_3d`: ops/cspn.py:cspn_nd on a [N, 26, D, H, W] guide: the gate
    normalization in PyTorch, then `cspn3d_fwd` (row 7) on bf16 gates;
  - `decompose_2d`: `probe_2d` at 4 and 24 steps, split into a fixed cost
    and a cost a step.

Two bounds a probe row, each the bytes over the card's peak memory rate
(utils/card.py:peaks):
  - `min_traffic_MB`, `hbm_sol_us`, `hbm_sol_fraction`: the JAX script's
    work-defined bytes: 2D, the 10 input planes at the I/O dtype's width
    read once and the float32 output written once, px * (io_bytes * 10 +
    4) (scripts/kernel_roofline.py:89); 3D, 26 gates, x0 and the output in
    float32, vx * 4 * 28 (:126);
  - `bytes_read_MB`, `read_sol_us`, `read_sol_fraction`: the bytes the
    port's kernel reads and writes: 2D, each input at the dtype the row
    feeds it (`port_2d_bytes`: 44 bytes a pixel all float32, 26 for bf16
    guidance and blur beside float32 sparse, 24 all bf16) and the float32
    output; 3D, bf16 gates, 60 bytes a voxel (PERF.md row 7).
The measured time also holds what the route runs in PyTorch around the
kernel (the 3D gate normalization) and the chain's feedback, so each
fraction is of the route, not the kernel alone.  On the
CPU the bounds are None: they are the card's.

Prints one JSON line a row and writes them to
result/torch_h100/kernel_roofline.jsonl.

    python -m cspn_tpu_torch.timing.kernel_roofline [--device cuda|cpu]
        [--out result/torch_h100/kernel_roofline.jsonl]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from cspn_tpu_torch import resolve_device
from cspn_tpu_torch.experiments import device_arg, platform_fields
from cspn_tpu_torch.timing import default_out, log, slope_seconds, write_jsonl

REPS_LO, REPS_HI, TRIALS = 16, 144, 5
def port_2d_bytes(guidance=torch.float32, blur=torch.float32, sparse=torch.float32) -> int:
    """Bytes a pixel the 2D kernel reads and writes: its 10 input planes (8
    gates, blur, sparse), each at the dtype it is fed (bf16 read as it is,
    float32 read as float32 at either io_dtype), and the float32 output."""
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    return 8 * size(guidance) + size(blur) + size(sparse) + 4


# all float32
PORT_2D_BYTES = port_2d_bytes()
# bytes a voxel the 3D kernel reads and writes: 26 bf16 gates, x0 and the
# output in float32
PORT_3D_BYTES = 2 * 26 + 4 + 4
# the JAX script's row keys, of a probe and of a decomposition
# (timing/__init__.py:missing_keys)
JAX_KEYS = dict.fromkeys(("kernel", "shape", "steps", "us", "us_per_frame", "min_traffic_MB",
                          "hbm_sol_us", "hbm_sol_fraction", "ps_per_px_step"))
JAX_DECOMPOSE_KEYS = dict.fromkeys(("kernel", "shape", "steps_pair", "us_lo", "us_hi",
                                    "fixed_us", "per_step_us", "compute_fraction_at_24",
                                    "per_step_ps_per_px"))


def hbm_bytes_per_s(device: torch.device) -> float | None:
    """The card's peak memory rate (None on the CPU)."""
    if device.type != "cuda":
        return None
    from cspn_tpu_torch.utils.card import peaks

    return peaks(torch.cuda.get_device_name(device))[0]


def roofline(t: float, n: int, px: int, steps: int, bytes_min: float, bytes_read: float,
             hbm_bps: float | None) -> dict:
    """The row's times and bounds from `t` seconds a call over `n` frames of
    `px` pixels (voxels) each: JAX's keys (kernel_roofline.py:93-103) and the
    bound on the bytes the port reads."""
    def bound(nbytes):  # (us, fraction of t); None on the CPU
        if hbm_bps is None:
            return None, None
        sol = nbytes / hbm_bps
        return round(sol * 1e6, 1), round(sol / t, 3)

    sol_us, sol_fraction = bound(bytes_min)
    read_us, read_fraction = bound(bytes_read)
    return {
        "us": round(t * 1e6, 1),
        "us_per_frame": round(t / n * 1e6, 2),
        "min_traffic_MB": round(bytes_min / 1e6, 1),
        "hbm_sol_us": sol_us,
        "hbm_sol_fraction": sol_fraction,
        "ps_per_px_step": round(t / (n * px * steps) * 1e12, 1),
        "bytes_read_MB": round(bytes_read / 1e6, 1),
        "read_sol_us": read_us,
        "read_sol_fraction": read_fraction,
    }


def roofline_2d(t: float, n: int, h: int, w: int, steps: int, io_dtype,
                hbm_bps: float | None, read_bytes: int = PORT_2D_BYTES) -> dict:
    """`roofline` of a 2D row: the work-defined bytes at `io_dtype`'s width,
    the bytes read `read_bytes` a pixel (`port_2d_bytes` of the inputs the
    row feeds)."""
    io_bytes = 2 if io_dtype is not None else 4
    px = n * h * w
    return roofline(t, n, h * w, steps, px * (io_bytes * 10 + 4), px * read_bytes, hbm_bps)


def roofline_3d(t: float, n: int, d: int, h: int, w: int, steps: int,
                hbm_bps: float | None) -> dict:
    vx = n * d * h * w
    return roofline(t, n, d * h * w, steps, vx * 4 * (26 + 1 + 1), vx * PORT_3D_BYTES, hbm_bps)


def decompose(lo_us: float, hi_us: float, n: int, h: int, w: int, steps_lo: int = 4,
              steps_hi: int = 24) -> dict:
    """t(s) = fixed + s * per_step from the times at two step counts
    (scripts/kernel_roofline.py:decompose_2d)."""
    per_step = (hi_us - lo_us) / (steps_hi - steps_lo)
    fixed = lo_us - steps_lo * per_step
    return {
        "steps_pair": [steps_lo, steps_hi],
        "us_lo": lo_us,
        "us_hi": hi_us,
        "fixed_us": round(fixed, 1),
        "per_step_us": round(per_step, 2),
        "compute_fraction_at_24": round(max(0.0, 1.0 - fixed / max(hi_us, 1e-9)), 3),
        "per_step_ps_per_px": round(per_step * 1e6 / (n * h * w), 1),
    }


def probe_2d(n=16, h=228, w=304, steps=24, io_dtype=None, device=None,
             reps=(REPS_LO, REPS_HI), trials=TRIALS) -> dict:
    from cspn_tpu_torch.ops import cspn2d

    dev = resolve_device(device)
    rng = np.random.default_rng()
    heads = torch.float32 if io_dtype is None else io_dtype  # the bf16 model's heads
    with torch.inference_mode():
        g = torch.from_numpy(rng.standard_normal((n, 8, h, w)).astype(np.float32)).to(dev, heads)
        b = torch.from_numpy(rng.standard_normal((n, h, w)).astype(np.float32)).to(dev, heads)
        s = torch.from_numpy(((rng.random((n, h, w)) < 0.01)
                              * np.abs(rng.standard_normal((n, h, w)))).astype(np.float32)).to(dev)

        def chain(k):
            def run():
                bi = b
                for _ in range(k):
                    y = cspn2d(g, bi, s, steps=steps, io_dtype=io_dtype, channel_first=True)
                    bi = (bi * 0.999 + y * 1e-6).to(b.dtype)
                return bi
            return run

        t, timing = slope_seconds(chain, b, rng, *reps, trials)
    return {
        "kernel": "cspn2d_tiled" + ("_bf16io" if io_dtype is not None else ""),
        "shape": f"{n}x{h}x{w}x8g",
        "steps": steps,
        "input_dtypes": [str(t.dtype).removeprefix("torch.") for t in (g, b, s)],
        **roofline_2d(t, n, h, w, steps, io_dtype, hbm_bytes_per_s(dev),
                      port_2d_bytes(g.dtype, b.dtype, s.dtype)),
        "timing": timing,
    }


def probe_3d(n=1, d=48, h=64, w=128, steps=24, device=None, reps=(REPS_LO, REPS_HI),
             trials=TRIALS) -> dict:
    from cspn_tpu_torch.ops import cspn_nd

    dev = resolve_device(device)
    rng = np.random.default_rng()
    with torch.inference_mode():
        g = torch.from_numpy(rng.standard_normal((n, 26, d, h, w)).astype(np.float32)).to(dev)
        f = torch.from_numpy(rng.standard_normal((n, 1, d, h, w)).astype(np.float32)).to(dev)

        def chain(k):
            def run():
                fi = f
                for _ in range(k):
                    fi = fi * 0.999 + cspn_nd(g, fi, steps=steps, channel_first=True) * 1e-6
                return fi
            return run

        t, timing = slope_seconds(chain, f, rng, *reps, trials)
    return {
        "kernel": "cspn3d_fwd",
        "shape": f"{n}x{d}x{h}x{w}x26g",
        "steps": steps,
        **roofline_3d(t, n, d, h, w, steps, hbm_bytes_per_s(dev)),
        "timing": timing,
    }


def decompose_2d(n, h, w, io_dtype=None, steps_lo=4, steps_hi=24, **timing) -> dict:
    """`probe_2d` at `steps_lo` and `steps_hi` steps: fixed cost (the
    inputs' reads, the output's write, the gates' fold, the launches) and
    cost a step."""
    lo = probe_2d(n=n, h=h, w=w, steps=steps_lo, io_dtype=io_dtype, **timing)
    hi = probe_2d(n=n, h=h, w=w, steps=steps_hi, io_dtype=io_dtype, **timing)
    return {"kernel": hi["kernel"] + "[decompose]", "shape": hi["shape"],
            **decompose(lo["us"], hi["us"], n, h, w, steps_lo, steps_hi),
            "timing": hi["timing"]}


# scripts/kernel_roofline.py:main's probes, in its order
PROBES = (
    (probe_2d, {}),
    (probe_2d, {"io_dtype": torch.bfloat16}),
    (probe_2d, {"n": 2, "h": 704, "w": 1216}),
    (probe_2d, {"n": 2, "h": 704, "w": 1216, "io_dtype": torch.bfloat16}),
    (probe_3d, {}),
    (decompose_2d, {"n": 16, "h": 228, "w": 304}),
    (decompose_2d, {"n": 2, "h": 704, "w": 1216}),
    (decompose_2d, {"n": 2, "h": 704, "w": 1216, "io_dtype": torch.bfloat16}),
    (decompose_2d, {"n": 2, "h": 704, "w": 1280}),
    (decompose_2d, {"n": 2, "h": 352, "w": 1216}),
)


def run(probes=PROBES, device=None, out: str | None = None, **timing) -> list[dict]:
    """Every probe's row (each also printed, and all written to `out`);
    `timing` overrides the probes' `reps` and `trials` (and sizes)."""
    dev = resolve_device(device)
    fields = platform_fields(dev)
    rows = []
    for probe, kw in probes:
        rows.append({**probe(**kw, device=dev, **timing), **fields})
        print(json.dumps(rows[-1]), flush=True)
        if out:
            write_jsonl(out, rows)
    log(f"kernel_roofline: {len(rows)} rows")
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.timing.kernel_roofline",
                                 description="the CSPN ops against their memory bounds")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=default_out("kernel_roofline", lines=True))
    return ap


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    return run(device=device_arg(args), out=args.out)


if __name__ == "__main__":
    main()
