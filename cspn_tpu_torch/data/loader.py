"""Batched, prefetching data loader (counterpart of cspn_tpu/data/loader.py).

Same batches in the same order as the JAX package's `DataLoader`: epoch `e`
shuffles `arange(len(dataset))` with `np.random.default_rng((seed, e))`,
takes the shard `[index::count]`, and cuts it into batches (the short last
one dropped with `drop_last`).  Batches are dicts of stacked numpy arrays.
Two worker modes:

  - 'thread' (default): a pool of worker threads builds up to `prefetch`
    batches ahead of the consumer;
  - 'process': a `torch.utils.data.DataLoader` over the epoch's batch index
    lists, with `num_workers` worker processes started by 'spawn' (never
    fork(): the parent may hold CUDA and threads), new for each epoch.  A
    worker hands its batch over as tensors, which travel through shared
    memory, not pickled through a pipe (a kitti_benchmark b4 batch is 34
    MB), and the consumer gets them back as numpy arrays.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Iterator

import numpy as np


def stack_samples(samples: list[dict]) -> dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class _IndexedBatches:
    """Map-style view of `dataset` whose item i is the stacked batch of the
    indices `batches[i]` (picklable for worker processes)."""

    def __init__(self, dataset, batches):
        self.dataset, self.batches = dataset, batches

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return stack_samples([self.dataset[int(j)] for j in self.batches[i]])


class _SharedBatches(_IndexedBatches):
    """_IndexedBatches whose items are tensors (for worker processes)."""

    def __getitem__(self, i):
        import torch

        return {k: torch.from_numpy(v) for k, v in super().__getitem__(i).items()}


def _unwrap(batch):
    return batch


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
        worker_mode: str = "thread",
    ):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be thread|process: {worker_mode!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.shard_index, self.shard_count = shard
        self.worker_mode = worker_mode
        self._epoch = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(idx)
        return idx[self.shard_index :: self.shard_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def next_epoch_batches(self) -> list[np.ndarray]:
        """The index lists of the next epoch's batches; advances the epoch."""
        indices = self._indices()
        self._epoch += 1
        n_batches = len(indices) // self.batch_size
        if len(indices) % self.batch_size and not self.drop_last:
            n_batches += 1
        return [indices[i * self.batch_size : (i + 1) * self.batch_size] for i in range(n_batches)]

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        batches = self.next_epoch_batches()
        if self.worker_mode == "process":
            yield from self._iter_processes(batches)
            return
        view = _IndexedBatches(self.dataset, batches)
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)
        try:
            pending = collections.deque(
                pool.submit(view.__getitem__, i) for i in range(min(self.prefetch, len(view))))
            next_task = len(pending)
            while pending:
                batch = pending.popleft().result()  # re-raises a worker's error
                if next_task < len(view):
                    pending.append(pool.submit(view.__getitem__, next_task))
                    next_task += 1
                yield batch
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _iter_processes(self, batches) -> Iterator[dict[str, np.ndarray]]:
        import torch.utils.data

        loader = torch.utils.data.DataLoader(
            _SharedBatches(self.dataset, batches),
            batch_size=None,  # each item already is a batch
            shuffle=False,
            num_workers=self.num_workers,
            collate_fn=_unwrap,
            prefetch_factor=self.prefetch,
            multiprocessing_context="spawn",
        )
        for batch in loader:
            yield {k: v.numpy() for k, v in batch.items()}
