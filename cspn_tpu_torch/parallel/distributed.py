"""Multi-process runtime (counterpart of cspn_tpu/parallel/distributed.py).

The JAX package wires its hosts with `jax.distributed.initialize`; here a
run of several processes joins one torch.distributed process group, NCCL
on the card and gloo on the CPU.  Nothing on a machine tells a program of
its cluster, so the caller names the rendezvous (`tcp://host:port` or
`file:///path`), the world size and the rank, or a launcher such as
`torchrun` sets them in the environment (WORLD_SIZE, RANK, MASTER_ADDR,
MASTER_PORT; `env://`).  `host_shard()` gives the (rank, world size) slice
for per-process input pipelines, `local_device()` the card a rank drives.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

_FILE = "file://"


def initialize_multihost(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    backend: str | None = None,
    retries: int = 3,
    retry_delay_s: float = 5.0,
    timeout_s: float = 300.0,
) -> None:
    """Join the process group.  A no-op on a single process (no
    `init_method`, a world size of None or 1 and no launcher's WORLD_SIZE in
    the environment) and when a group exists.  Under a launcher (torchrun),
    the group is joined from the environment, at any world size.

    Every attempt waits at most `timeout_s` for the rendezvous (and the
    group's collectives at most as long); a failed attempt (workers racing
    the first process at start-up) is retried `retries` times with linear
    backoff before the error propagates.  A `file://` rendezvous takes the
    rest of the string as the store's path, as it is: torch's URL parsing
    would cut a path at a '?' or '#' (two runs whose paths share the part
    before one would meet in one store)."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and "WORLD_SIZE" in os.environ:
        init_method = "env://"
    if init_method is None and world_size in (None, 1):
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    last_err: Exception | None = None
    for attempt in range(max(retries, 1)):
        try:
            kw = (dict(store=dist.FileStore(init_method[len(_FILE):], world_size))
                  if init_method and init_method.startswith(_FILE)
                  else dict(init_method=init_method))
            dist.init_process_group(backend, world_size=world_size, rank=rank,
                                    timeout=datetime.timedelta(seconds=timeout_s), **kw)
            return
        except (RuntimeError, ValueError) as e:  # DistStoreError is a RuntimeError
            last_err = e
            if attempt + 1 < max(retries, 1):
                time.sleep(retry_delay_s * (attempt + 1))
    raise last_err


def host_shard() -> tuple[int, int]:
    """(rank, world size) for per-process input pipeline sharding."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device: str | torch.device) -> torch.device:
    """`device`, on the card: with no index under a process group, this
    rank's card (the launcher's LOCAL_RANK, else the rank modulo the cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not dist.is_initialized():
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)
