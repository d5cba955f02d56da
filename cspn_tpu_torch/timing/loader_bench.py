"""The data loader's throughput from files on disk against the card's
demand (counterpart of scripts/loader_bench.py).

`make_fixtures` writes NYU-shaped frames with the JAX script's seed-0
draws (rgb 3x480x640 uint8, depth 480x640 float32 in [0.1, 10)): h5 files
where h5py imports, and PNG pairs (rgb, and depth * 25.5 as 8-bit grey)
through utils/images.py:write_png, with a manifest each.  The sweep
(`CFGS`, scripts/loader_bench.py:114-128) then iterates
data/loader.py:DataLoader over data/datasets.py:NyuDepthDataset at the
flagship geometry (228x304 out of 480x640): threads or the persistent
process pool, the train chain or the val chain, the host library on or
off, several worker counts; an epoch to warm, then the frames/s of 3.

A row whose fixtures this machine cannot write (h5 without h5py) or whose
route it cannot run (the transforms chain without PIL) goes under
`skipped` with the reason; an h5 row runs on the PNG fixtures instead, as
a row of format `img`, so every worker mode, both routes and both splits
still appear where PNGs can be read.

The summary (`summarize`) is the JAX script's: the best train rate a worker
on the primary format (h5 where it was measured, else img), the best val
rate a worker, and the workers it takes to feed the card at its demand.
The demand is the card's: eval, the port's `bench` line (nyu_eval b128,
EVAL_DEMAND); train, timing/train_bench's frames/s in this run (measured
here at its defaults unless --device-train-fps gives it).

    python -m cspn_tpu_torch.timing.loader_bench [--frames 96] [--batch 8]
        [--device-eval-fps F] [--device-train-fps F] [--device cuda|cpu]
        [--out result/torch_h100/loader_bench.json]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import tempfile
import time

import numpy as np

from cspn_tpu_torch.experiments import device_arg, platform_fields, write_json
from cspn_tpu_torch.timing import default_out, log, train_bench

# the port's bench line on the card (python -m cspn_tpu_torch bench: nyu_eval
# b128 frames/s; PERF.md section 2, chip_smoke.py phase 16) and the card
EVAL_DEMAND = (1577.45, "NVIDIA H100 80GB HBM3, 700.00 W")
# the batch of the train demand: timing/train_bench's default
TRAIN_BATCH = train_bench.build_parser().get_default("batch")
# (mode, format, split, native, workers); None workers: max(4, host cores)
CFGS = (
    ("thread", "hdf5", "train", True, 1),
    ("thread", "hdf5", "train", True, 2),
    ("thread", "hdf5", "train", True, None),
    ("process", "hdf5", "train", True, 1),
    ("process", "hdf5", "train", True, 2),
    ("process", "hdf5", "train", True, None),
    ("thread", "hdf5", "train", False, 2),
    ("thread", "hdf5", "val", True, 2),
    ("process", "hdf5", "val", True, 2),
    ("thread", "hdf5", "val", False, 2),
    ("thread", "img", "train", True, 2),
)
EPOCHS = 3
# the JAX script's artifact keys (timing/__init__.py:missing_keys)
JAX_KEYS = {
    **dict.fromkeys(("what", "host_cores", "device_demand_fps", "train_fps_per_worker",
                     "val_fps_per_worker", "workers_to_feed_train", "workers_to_feed_eval")),
    "results": [dict.fromkeys(("mode", "format", "split", "native", "workers", "frames_per_s",
                               "frames_per_s_per_worker"))],
}


def h5py_available() -> bool:
    return importlib.util.find_spec("h5py") is not None


def pil_available() -> bool:
    return importlib.util.find_spec("PIL") is not None


def make_fixtures(root: str, frames: int) -> tuple[str | None, str]:
    """Write `frames` NYU-shaped frames as h5 files (where h5py imports)
    and PNG pairs, and their manifests; returns (h5 manifest or None, img
    manifest).  The frames are scripts/loader_bench.py:make_fixtures's."""
    from cspn_tpu_torch.utils.images import write_png

    h5 = h5py_available()
    h5_dir, img_dir = os.path.join(root, "h5"), os.path.join(root, "img")
    os.makedirs(img_dir, exist_ok=True)
    if h5:
        import h5py

        os.makedirs(h5_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    h5_rows, img_rows = [], []
    for i in range(frames):
        rgb = rng.integers(0, 256, (3, 480, 640), dtype=np.uint8)
        depth = (rng.random((480, 640)) * 9.9 + 0.1).astype(np.float32)
        if h5:
            p = os.path.join(h5_dir, f"{i:05d}.h5")
            with h5py.File(p, "w") as f:
                f["rgb"] = rgb
                f["depth"] = depth
            h5_rows.append(p)
        rp = write_png(os.path.join(img_dir, f"{i:05d}_rgb.png"), rgb.transpose(1, 2, 0))
        dp = write_png(os.path.join(img_dir, f"{i:05d}_depth.png"),
                       (depth * 25.5).astype(np.uint8))
        img_rows.append((rp, dp))
    h5_csv = None
    if h5:
        h5_csv = os.path.join(root, "h5.csv")
        with open(h5_csv, "w") as f:
            f.write("Name\n" + "\n".join(h5_rows) + "\n")
    img_csv = os.path.join(root, "img.csv")
    with open(img_csv, "w") as f:
        f.write("Rgb,Depth\n" + "\n".join(f"{r},{d}" for r, d in img_rows) + "\n")
    return h5_csv, img_csv


def bench_one(csv_file: str, input_format: str, split: str, use_native: bool, workers: int,
              batch: int, epochs: int = EPOCHS, worker_mode: str = "thread") -> float:
    """Frames/s of the loader over `epochs` epochs after one to warm."""
    from cspn_tpu_torch.data import DataLoader
    from cspn_tpu_torch.data.datasets import NyuDepthDataset

    ds = NyuDepthDataset(csv_file, split=split, seed=0, use_native=use_native,
                         input_format=input_format)
    loader = DataLoader(ds, batch, shuffle=split == "train", drop_last=True, num_workers=workers,
                        worker_mode=worker_mode)
    try:
        for _ in loader:  # epoch 0 warms the page cache, the pool and the host library
            pass
        t0 = time.perf_counter()
        n = 0
        for _ in range(epochs):
            for b in loader:
                n += b["rgbd"].shape[0]
        return n / (time.perf_counter() - t0)
    finally:
        loader.close()


def summarize(rows: list[dict], eval_fps: float, train_fps: float) -> dict:
    """The best train rate a worker on the primary format (h5 where it was
    measured, else img), the best val rate a worker, and the workers that
    feed the card at `eval_fps` and `train_fps`
    (scripts/loader_bench.py:147-153)."""
    fmt = "hdf5" if any(r["format"] == "hdf5" for r in rows) else "img"
    best = max(r["frames_per_s_per_worker"] for r in rows
               if r["split"] == "train" and r["format"] == fmt)
    best_val = max(r["frames_per_s_per_worker"] for r in rows if r["split"] == "val")
    return {
        "train_fps_per_worker": best,
        "val_fps_per_worker": best_val,
        "workers_to_feed_train": int(np.ceil(train_fps / best)),
        "workers_to_feed_eval": int(np.ceil(eval_fps / best_val)),
    }


def sweep_plan(cfgs, cores: int, h5: bool, pil: bool) -> tuple[list[tuple], list[dict]]:
    """(the rows to run, each once, in order; the skipped ones with their
    reasons): an h5 row runs on the PNGs where h5 files cannot be written,
    a row of the transforms chain is skipped without PIL."""
    plan, skipped = [], []
    for mode, fmt, split, native, workers in cfgs:
        workers = max(4, cores) if workers is None else workers
        cfg = {"mode": mode, "format": fmt, "split": split, "native": native, "workers": workers}
        if not native and not pil:
            skipped.append({**cfg, "reason": "PIL is not installed: the transforms chain "
                                             "(native off) cannot run"})
            continue
        if fmt == "hdf5" and not h5:
            skipped.append({**cfg, "reason": "h5py is not installed: no h5 fixtures; run on "
                                             "the PNG fixtures as format img"})
            fmt = "img"
        row = (mode, fmt, split, native, workers)
        if row not in plan:
            plan.append(row)
    return plan, skipped


def train_demand(device) -> float:
    """timing/train_bench's frames/s at its defaults on `device`."""
    tb = train_bench.build_parser().parse_args(["--device", str(device)])
    return train_bench.run(tb)["value"]


def run(args, cfgs=CFGS) -> dict:
    dev = device_arg(args)
    fields = platform_fields(dev)
    if args.device_train_fps is None:
        if dev.type != "cuda":
            raise SystemExit("the train demand is the card's: on the CPU give --device-train-fps")
        card = fields["card"]
        train_fps = train_demand(dev)
        train_src = f"timing/train_bench in this run, {card['name']}, {card['power_limit']}"
    else:
        train_fps, train_src = args.device_train_fps, "--device-train-fps"
    if args.device_eval_fps is None:
        eval_fps = EVAL_DEMAND[0]
        eval_src = f"python -m cspn_tpu_torch bench (nyu_eval b128), {EVAL_DEMAND[1]}"
    else:
        eval_fps, eval_src = args.device_eval_fps, "--device-eval-fps"
    cores = os.cpu_count() or 1
    plan, skipped = sweep_plan(cfgs, cores, h5py_available(), pil_available())
    for s in skipped:
        log(f"loader_bench: skipped {s}")
    root = tempfile.mkdtemp(prefix="loader_bench_")
    try:
        h5_csv, img_csv = make_fixtures(root, args.frames)
        rows = []
        for mode, fmt, split, native, workers in plan:
            fps = bench_one(img_csv if fmt == "img" else h5_csv, fmt, split, native, workers,
                            args.batch, worker_mode=mode)
            rows.append({"mode": mode, "format": fmt, "split": split, "native": native,
                         "workers": workers, "frames_per_s": round(fps, 1),
                         "frames_per_s_per_worker": round(fps / min(workers, cores), 1)})
            log(f"loader_bench: {rows[-1]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {
        "what": "DataLoader throughput from disk fixtures at flagship geometry (228x304 out "
                "of 480x640 NYU-shaped frames) on the PyTorch port's loader; see "
                "cspn_tpu_torch/timing/loader_bench.py",
        **fields,
        "host_cores": cores,
        "device_demand_fps": {"eval_b128": eval_fps, f"train_b{TRAIN_BATCH}": train_fps},
        "device_demand_source": {"eval_b128": eval_src, f"train_b{TRAIN_BATCH}": train_src},
        "results": rows,
        "skipped": skipped,
        **summarize(rows, eval_fps, train_fps),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cspn_tpu_torch.timing.loader_bench",
                                 description="DataLoader frames/s from disk fixtures against "
                                             "the card's demand")
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=default_out("loader_bench"))
    ap.add_argument("--device-eval-fps", type=float, default=None,
                    help=f"default: the port's bench line, {EVAL_DEMAND[0]} frames/s on "
                         f"{EVAL_DEMAND[1]}")
    ap.add_argument("--device-train-fps", type=float, default=None,
                    help="default: timing/train_bench at its defaults, measured on --device "
                         "(a card; required on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None, cfgs=CFGS) -> dict:
    args = build_parser().parse_args(argv)
    rec = run(args, cfgs)
    write_json(args.out, rec)
    print(json.dumps({k: rec[k] for k in ("host_cores", "train_fps_per_worker",
                                           "val_fps_per_worker", "workers_to_feed_train",
                                           "workers_to_feed_eval")}), flush=True)
    return rec


if __name__ == "__main__":
    main()
