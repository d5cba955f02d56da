"""One train sample's host cost stage by stage (counterpart of
scripts/loader_profile.py).

On timing/loader_bench.py's fixtures (480x640 NYU-shaped frames, warm
page cache; h5 files where h5py imports, else the PNG pairs), the cost a
frame of NyuDepthDataset's train sample on the host library's route
(data/datasets.py:_native_fast_sample), split into:

  - decode: `_load_arrays` (h5 reads and the CHW->HWC view, or the PNG
    decode), named after the fixtures' format (`decode_h5_ms` or
    `decode_png_ms`);
  - aug: the one-pass chain (data/native.py:aug_pack) on the same decoded
    frames, its stages toggled on one at a time -- pack only, + resize, +
    rotate, + jitter, + flip -- with the JAX script's parameter draws
    (scripts/loader_profile.py:76-90), so each delta prices one stage;
  - python: the rest of `ds[i]` (its RNG draws, the dict), the end to end
    time less decode and the full chain.

One thread, the median of `reps` passes over the frames.  Writes
result/torch_h100/loader_profile.json.

    python -m cspn_tpu_torch.timing.loader_profile [--frames 64] [--reps 5]
        [--device cuda|cpu] [--out result/torch_h100/loader_profile.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time

import numpy as np

from cspn_tpu_torch.experiments import device_arg, platform_fields, write_json
from cspn_tpu_torch.timing import default_out
from cspn_tpu_torch.timing.loader_bench import make_fixtures

# the aug ladder: each rung turns one more stage on
LADDER = {
    "pack_only": {},
    "resize": {"resize": True},
    "resize_rotate": {"resize": True, "rotate": True},
    "resize_rotate_jitter": {"resize": True, "rotate": True, "jitter": True},
    "full_chain": {"resize": True, "rotate": True, "jitter": True, "flip": True},
}


def jax_keys(fmt: str = "h5") -> dict:
    """The JAX script's artifact keys (timing/__init__.py:missing_keys), its
    decode stage named after the fixtures' format."""
    return {
        **dict.fromkeys(("what", "host_cores", "frames", "implied_single_worker_fps",
                         "dominant", "aug_share", "decode_share")),
        "stages_ms_per_frame": dict.fromkeys((
            f"decode_{fmt}_ms", "aug_pack_only_ms", "aug_resize_delta_ms", "aug_rotate_delta_ms",
            "aug_jitter_delta_ms", "aug_flip_delta_ms", "aug_full_chain_ms",
            "python_residual_ms", "e2e_ms")),
    }


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def aug_params(ds, frames: int) -> list[dict]:
    """A frame's aug_pack parameters, drawn as scripts/loader_profile.py:76-90."""
    from cspn_tpu_torch.data import transforms as T

    rng = np.random.default_rng(0)
    params = []
    for _ in range(frames):
        s = float(rng.uniform(1.0, 1.5))
        params.append({
            "resize_hw": ds._resize_shorter(480, 640, int(ds.resize_base * s)),
            "angle": float(rng.uniform(-5.0, 5.0)),
            "jitter": T.ColorJitter.draw_params(0.4, 0.4, 0.4, rng),
            "flip": True,
            "inv_scale": 1.0 / s,
        })
    return params


def stage_record(decode_ms: float, ladder_ms: dict, e2e_ms: float, fmt: str) -> dict:
    """stages_ms_per_frame, implied_single_worker_fps, dominant, aug_share
    and decode_share from the stages' ms a frame
    (scripts/loader_profile.py:128-161); the decode key names `fmt`."""
    stages = {
        f"decode_{fmt}_ms": round(decode_ms, 3),
        "aug_pack_only_ms": round(ladder_ms["pack_only"], 3),
        "aug_resize_delta_ms": round(ladder_ms["resize"] - ladder_ms["pack_only"], 3),
        "aug_rotate_delta_ms": round(ladder_ms["resize_rotate"] - ladder_ms["resize"], 3),
        "aug_jitter_delta_ms": round(
            ladder_ms["resize_rotate_jitter"] - ladder_ms["resize_rotate"], 3),
        "aug_flip_delta_ms": round(ladder_ms["full_chain"] - ladder_ms["resize_rotate_jitter"], 3),
        "aug_full_chain_ms": round(ladder_ms["full_chain"], 3),
        "python_residual_ms": round(e2e_ms - decode_ms - ladder_ms["full_chain"], 3),
        "e2e_ms": round(e2e_ms, 3),
    }
    aug_share = ladder_ms["full_chain"] / e2e_ms
    return {
        "stages_ms_per_frame": stages,
        "implied_single_worker_fps": round(1e3 / e2e_ms, 1),
        "dominant": ("augmentation" if aug_share > 0.5
                     else "decode" if decode_ms / e2e_ms > 0.5 else "mixed"),
        "aug_share": round(aug_share, 3),
        "decode_share": round(decode_ms / e2e_ms, 3),
    }


def run(args) -> dict:
    from cspn_tpu_torch.data import native
    from cspn_tpu_torch.data.datasets import NyuDepthDataset

    fields = platform_fields(device_arg(args))
    if not native.aug_available():
        raise RuntimeError("the host library (csrc/host_pipeline.cpp) did not build: "
                           + native.build_error())
    tmp = tempfile.mkdtemp(prefix="loader_profile_")
    try:
        h5_csv, img_csv = make_fixtures(tmp, args.frames)
        fmt = "h5" if h5_csv else "png"
        ds = NyuDepthDataset(h5_csv or img_csv, root_dir=tmp, split="train", n_sample=500,
                             input_format="hdf5" if h5_csv else "img")
        idxs = range(args.frames)
        decode_ms = median_ms(lambda: [ds._load_arrays(i) for i in idxs],
                              args.reps) / args.frames
        arrays = [ds._load_arrays(i) for i in idxs]
        params = aug_params(ds, args.frames)

        def run_aug(resize=False, rotate=False, jitter=False, flip=False):
            for (rgb, depth), p in zip(arrays, params):
                native.aug_pack(rgb, depth, resize_hw=p["resize_hw"] if resize else None,
                                angle=p["angle"] if rotate else 0.0, crop_hw=ds.crop_hw,
                                flip=p["flip"] if flip else False,
                                jitter=p["jitter"] if jitter else [],
                                inv_scale=p["inv_scale"], n_sample=ds.n_sample,
                                sparse_denom=ds.sparse_denom, seed=7)

        ladder_ms = {name: median_ms(lambda kw=kw: run_aug(**kw), args.reps) / args.frames
                     for name, kw in LADDER.items()}
        e2e_ms = median_ms(lambda: [ds[i] for i in idxs], args.reps) / args.frames
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "what": "per-stage host cost of one train sample on the PyTorch port's host-library "
                f"route ({fmt} fixture of 480x640 NYU-shaped frames -> 228x304 rgbd); deltas "
                "price one aug stage each; see cspn_tpu_torch/timing/loader_profile.py",
        **fields,
        "host_cores": os.cpu_count(),
        "frames": args.frames,
        **stage_record(decode_ms, ladder_ms, e2e_ms, fmt),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.timing.loader_profile",
                                 description="one train sample's host cost stage by stage")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=default_out("loader_profile"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu: the card the "
                    "record names")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rec = run(args)
    write_json(args.out, rec)
    print(json.dumps(rec, indent=1), flush=True)
    return rec


if __name__ == "__main__":
    main()
