"""Frozen operation and byte counts of each configuration.

    python perfbench/work/count.py [--write]

For every configuration file under perfbench/configs/, counts from the
layer list at published widths (reference/layers.py), not from the
program's modules:

  - `conv_flops_per_frame.forward`: 2 x multiply-adds of every convolution
    of one frame's forward.  A convolution on a zero-insert unpooled map
    counts only the taps that land on the map's non-zero entries (the
    work those inputs need); every other convolution counts its whole
    kernel at every output pixel, padding included.  Batch norms, pooling,
    the 2D CSPN (~20 FLOP a pixel-step) and elementwise work are left out.
  - `conv_flops_per_frame.train`: 3 x the forward (the backward's two
    products per convolution).
  - `cspn2d_bytes_per_frame`: the bytes the 2D CSPN op must move for one
    frame: `serve`, its inputs read once and its output written once at
    the served dtypes (8 bf16 affinities, bf16 blur, float32 sparse, float32
    output: 26 bytes a pixel); `train`, the forward's inputs and output (11
    float32 planes) and the backward's inputs and gradients (20 float32
    planes) once each, 124 bytes a pixel.  States a route keeps for itself
    are not counted.

`--write` writes perfbench/work/<config>.json; without it the counts are
printed.  tests/test_pb_work.py holds the written files to a fresh count.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
if __name__ == "__main__":  # the checkout, in place of this script's directory
    sys.path[0] = str(HERE.parent.parent)

from perfbench.reference import layers  # noqa: E402

CONFIGS = HERE.parent / "configs"
CSPN_SERVE_BYTES_PER_PX = 8 * 2 + 2 + 4 + 4
CSPN_TRAIN_BYTES_PER_PX = (11 + 20) * 4


def _taps_1d(n: int, k: int, unpooled: bool) -> int:
    """Sum over the n outputs of one axis of the kernel taps counted (a
    stride-1 'same' convolution of an n-long axis)."""
    if not unpooled:
        return n * k
    p = (k - 1) // 2
    return sum(1 for y in range(n) for i in range(k) if 0 <= y + i - p < n and (y + i - p) % 2 == 0)


def conv_flops(arch: str, h: int, w: int, in_channels: int = 4) -> dict[str, int]:
    """{conv name: FLOPs of one frame} at an h x w input."""
    sizes = layers.ceil_half_chain(h, w, 5)
    out_size = {"conv1_1": sizes[1], "conv2": sizes[5]}
    for c in layers.encoder_convs(arch, in_channels):
        if c.name.startswith("layer"):
            out_size[c.name] = sizes[int(c.name[5]) + 1]
    for stage, b, kind, _, _, s, _ in layers.blocks(arch):
        if kind == "bottleneck" and s != 1:  # the 1x1 before the strided 3x3: input resolution
            out_size[f"layer{stage}.{b}.conv1"] = sizes[stage]
    for c in layers.decoder_convs(arch):
        block = int(c.name.split(".")[0][-1])
        out_size[c.name] = sizes[max(5 - block, 0)]
    flops = {}
    for c in layers.convs(arch, in_channels):
        oh, ow = out_size[c.name]
        taps = (_taps_1d(oh, c.k, c.unpooled) * _taps_1d(ow, c.k, c.unpooled))
        flops[c.name] = 2 * c.cin * c.cout * taps
    return flops


def counts(config: dict) -> dict:
    h, w = config["frame"]
    fwd = sum(conv_flops(config["arch"], h, w, config["in_channels"]).values())
    return {
        "config": config["name"],
        "arch": config["arch"],
        "height": h,
        "width": w,
        "conv_flops_per_frame": {"forward": fwd, "train": 3 * fwd},
        "cspn2d_bytes_per_frame": {"serve": CSPN_SERVE_BYTES_PER_PX * h * w,
                                   "train": CSPN_TRAIN_BYTES_PER_PX * h * w},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    for path in sorted(CONFIGS.glob("*.json")):
        out = counts(json.loads(path.read_text()))
        text = json.dumps(out, indent=1) + "\n"
        if args.write:
            (HERE / path.name).write_text(text)
        print(text, end="")


if __name__ == "__main__":
    main()
