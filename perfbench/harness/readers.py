"""What the per-layer readers (perfbench/metrics/) share: the kind of a
device kernel by its name, and the shares of a peak or a bound.  A reader
that finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations


def kind(kernel: str) -> str:
    """The program's 2D CSPN kernels by name (csrc/*.cu); the sharded
    segment's first, since its backward's epilogue holds the 2D backward's
    name."""
    k = kernel.lower()
    if "halo_seg" in k or "keep_epilogue_kernel" in k:
        return "cspn2d_halo_seg"
    if "cspn2d_tiled_kernel" in k:
        return "cspn2d_tiled"
    if "cspn2d_fwd_kernel" in k:
        return "cspn2d_fwd"
    if "replay_tile_kernel" in k or "reverse_tile_kernel" in k or "epilogue_kernel" in k:
        return "cspn2d_bwd"
    return "other"


def idle_pct(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def flops_share(r, which: str, peak: str):
    t = r.trace
    if t is None or not t.frames or not r.peaks:
        return None
    flops = r.cell.work["conv_flops_per_frame"][which] * t.frames
    return 100.0 * flops / t.window_s / r.peaks[peak]


def roofline(r, which: str, kinds: tuple):
    t = r.trace
    if t is None or not t.frames or not r.peaks:
        return None
    seconds = sum(s for name, s in t.kernel_s.items() if kind(name) in kinds)
    if seconds <= 0:
        return None
    bound_s = r.cell.work["cspn2d_bytes_per_frame"][which] * t.frames / r.peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / seconds
