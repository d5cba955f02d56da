"""Scaling benchmark: throughput against the size of the data axis
(counterpart of cspn_tpu/utils/scaling.py:run_scaling_bench and the
`bench-scaling` subcommand).

Weak scaling: a fixed batch per rank, mesh sizes 1, 2, 4, ... N over the
data axis (times `spatial`).  Each size spawns its ranks afresh (one
process each, a process group through a `file://` store: NCCL, one card a
rank, on the card; gloo on the CPU), and every rank times `iters` steps
after `warmup`, each ending in a synchronization:

  - train: the data-parallel train step of a CSPN-UNet (train/loop.py:
    make_train_step through parallel/data.py's default route, sync-BN and
    a float32 reduce), spatial sharding as the JAX bench hands its mesh to
    the model (`spatial_mesh`) where spatial > 1;
  - eval: the same model's eval-mode forward on each rank's rows;
  - stereo: the stereo train step (train/stereo_loop.py) at a small
    geometry, as the JAX bench's stereo mode.

One record a size: {devices, spatial, batch, model, ms_per_step,
frames_per_s, efficiency}, efficiency = fps / (devices * fps_1), rank 0's
times.  On the CPU the ranks share the host's cores, so the records show
the mechanics (sharding, collectives, the harness), not scaling: each then
carries that note, as the JAX bench's virtual CPU mesh does.  One H100
gives the one point a single card allows.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

CPU_NOTE = ("cpu-mesh mechanics only: the ranks share host cores; validates "
            "sharding/collectives, NOT a scaling measurement")


def _mesh_sizes(n: int) -> list[int]:
    sizes, s = [], 1
    while s <= n:
        sizes.append(s)
        s *= 2
    if sizes[-1] != n:
        sizes.append(n)
    return sizes


def _worker(rank: int, world: int, store: str, out: str, cfg: dict) -> None:
    """One rank of one mesh size: join the group, time the steps, and
    (rank 0) write the record to `out`."""
    import torch
    import torch.distributed as dist

    from cspn_tpu_torch import set_conv_policy
    from cspn_tpu_torch.parallel.distributed import initialize_multihost

    on_cuda = cfg["device"] == "cuda"
    if on_cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_multihost(store, world, rank, backend="nccl" if on_cuda else "gloo", retries=1)
    try:
        device = torch.device("cuda", rank) if on_cuda else torch.device("cpu")
        set_conv_policy(device)  # as the entry points: cuDNN's algorithm timing, TF32 off
        step, batch, model = _build_step(cfg, world, device)
        for _ in range(cfg["warmup"]):
            step()
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(cfg["iters"]):
            step()
        _sync(device)
        dt = (time.perf_counter() - t0) / cfg["iters"]
        if rank == 0:
            record = {"devices": world // cfg["spatial"], "spatial": cfg["spatial"], "batch": batch,
                      "model": model, "ms_per_step": dt * 1e3, "frames_per_s": batch / dt}
            if not on_cuda:
                record["note"] = CPU_NOTE
            record["device"] = torch.cuda.get_device_name(device) if on_cuda else "cpu"
            with open(out, "w") as f:
                json.dump(record, f)
    finally:
        dist.destroy_process_group()


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_step(cfg: dict, world: int, device):
    """(step(), global batch, model name) for this rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cspn_tpu_torch.parallel.data import DataParallel
    from cspn_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch

    mesh = make_mesh(None, cfg["spatial"], dist.group.WORLD)
    data = mesh.data
    rng = np.random.default_rng(0)
    h, w = cfg["hw"]
    batch = cfg["batch_per_device"] * data
    if cfg["mode"] == "stereo":
        from cspn_tpu_torch.train.state import make_optimizer
        from cspn_tpu_torch.train.stereo_loop import (StereoConfig, build_stereo_model,
                                                      make_stereo_train_step)

        scfg = StereoConfig(max_disp=4 * max(h // 16, 1), features=8,
                            cspn_steps=min(cfg["cspn_steps"], 4))
        model = build_stereo_model(scfg, train=True, device=device)
        arrays = {"left": rng.standard_normal((batch, h, w, 3)),
                  "right": rng.standard_normal((batch, h, w, 3)),
                  "disp": rng.uniform(0, scfg.max_disp - 1, (batch, h, w))}
        rows = {k: torch.tensor(v, dtype=torch.float32, device=device)
                for k, v in shard_batch(arrays, mesh).items()}
        optimizer = make_optimizer(model.parameters(), scfg.lr, momentum=0.9, weight_decay=1e-4,
                                   nesterov=False)
        step = make_stereo_train_step(model, optimizer, float(scfg.max_disp),
                                      data_parallel=DataParallel(model, mesh))
        return (lambda: step(rows["left"], rows["right"], rows["disp"])), batch, "PSMNetCSPN"

    from cspn_tpu_torch.models.resnet import init_weights
    from cspn_tpu_torch.models.unet import _make
    from cspn_tpu_torch.train.loop import make_train_step
    from cspn_tpu_torch.train.state import make_optimizer

    train = cfg["mode"] == "train"
    depth = int(cfg["arch"].replace("resnet", ""))
    # the spatial axis shards the model's CSPN rows, as the JAX bench hands the model its mesh
    spatial = Mesh(cfg["spatial"], mesh.group) if cfg["spatial"] > 1 else None
    model = _make(depth, True, cspn_steps=cfg["cspn_steps"], spatial_mesh=spatial).to(device)
    init_weights(model, torch.Generator(device).manual_seed(0))
    arrays = {"rgbd": rng.standard_normal((batch, h, w, 4)),
              "depth": np.abs(rng.standard_normal((batch, h, w)))}
    rows = {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in shard_batch(arrays, mesh).items()}
    if train:
        optimizer = make_optimizer(model.parameters(), 0.01)
        step = make_train_step(model, optimizer, "l1", DataParallel(model, mesh))
        return (lambda: step(rows["rgbd"], rows["depth"])), batch, cfg["arch"]
    model.eval()

    @torch.inference_mode()
    def forward():
        return model(rows["rgbd"])

    return forward, batch, cfg["arch"]


def run_scaling_bench(
    arch: str = "resnet18",
    hw: tuple[int, int] = (228, 304),
    batch_per_device: int = 4,
    cspn_steps: int = 24,
    mode: str = "train",
    warmup: int = 2,
    iters: int = 8,
    spatial: int = 1,
    max_devices: int | None = None,
    device: str = "cuda",
) -> list[dict]:
    """One record per mesh size (see the module docstring).  `device`
    'cuda' takes one card a rank, up to the cards visible (or
    `max_devices`); 'cpu' runs `max_devices` gloo ranks on the host."""
    import torch
    import torch.multiprocessing as mp

    if mode not in ("train", "eval", "stereo"):
        raise ValueError(f"mode {mode!r}: train, eval or stereo")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench-scaling on 'cuda' needs a card; pass device='cpu' for the "
                               "CPU mechanics")
        n_dev = torch.cuda.device_count()
        n_dev = n_dev if max_devices is None else min(n_dev, max_devices)
    else:
        n_dev = max_devices or 1
        print(f"# NOTE: {CPU_NOTE}", file=sys.stderr, flush=True)
    cfg = {"arch": arch, "hw": tuple(hw), "batch_per_device": batch_per_device,
           "cspn_steps": cspn_steps, "mode": mode, "warmup": warmup, "iters": iters,
           "spatial": spatial, "device": device}
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        for n in _mesh_sizes(n_dev):
            world = n * spatial
            if world > n_dev:
                break
            store, out = f"file://{tmp}/store{n}", os.path.join(tmp, f"record{n}.json")
            mp.start_processes(_worker, args=(world, store, out, cfg), nprocs=world, join=True,
                               start_method="spawn")
            with open(out) as f:
                records.append(json.load(f))
    fps1 = records[0]["frames_per_s"]
    for r in records:
        r["efficiency"] = r["frames_per_s"] / (r["devices"] * fps1)
    return records
