"""Batched, prefetching data loader (counterpart of cspn_tpu/data/loader.py).

Same batches in the same order as the JAX package's `DataLoader`: epoch `e`
shuffles `arange(len(dataset))` with `np.random.default_rng((seed, e))`,
takes the shard `[index::count]`, and cuts it into batches (the short last
one dropped with `drop_last`).  Batches are dicts of stacked numpy arrays.
Two worker modes:

  - 'thread' (default): a pool of worker threads builds up to `prefetch`
    batches ahead of the consumer;
  - 'process': a persistent pool of `num_workers` worker processes started
    by 'spawn' (never fork(): the parent may hold CUDA and threads), fed
    batch index lists over a queue, as the JAX package's loader
    (cspn_tpu/data/loader.py:12-25, 179-300).  The pool is built at the
    first process-mode iteration and serves every later epoch (a spawned
    worker takes seconds to import torch and the package); a worker's
    death raises in the iteration that waits on it, and the next
    iteration builds a new pool; each task carries an id, so that batches
    of an abandoned iteration never reach a later one; `close()` (or the
    loader's deletion) ends the workers.  A worker hands its batch over as
    tensors, which travel through shared memory, not pickled through a
    pipe (a kitti_benchmark b4 batch is 34 MB), and the consumer gets them
    back as numpy arrays.
"""

from __future__ import annotations

import collections
import concurrent.futures
import queue
import traceback
from typing import Iterator

import numpy as np


# process mode: seconds between the consumer's checks that its workers
# live, and how long live workers may stay silent on one batch before the
# iteration declares them hung (as the JAX package's stall_timeout)
_POLL_S = 1.0
_STALL_S = 300.0


def stack_samples(samples: list[dict]) -> dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class _IndexedBatches:
    """Map-style view of `dataset` whose item i is the stacked batch of the
    indices `batches[i]`."""

    def __init__(self, dataset, batches):
        self.dataset, self.batches = dataset, batches

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return stack_samples([self.dataset[int(j)] for j in self.batches[i]])


def _process_worker(dataset, task_q, result_q):
    """A worker process's loop: (task id, indices) in, (task id, the batch
    as tensors, which the queue hands over through shared memory) out;
    an error travels back as (task id, ("error", its traceback))."""
    import torch
    import torch.multiprocessing  # noqa: F401  (the tensors' shared-memory reductions)

    while True:
        msg = task_q.get()
        if msg is None:
            return
        task_id, idx = msg
        try:
            batch = stack_samples([dataset[int(j)] for j in idx])
            result_q.put((task_id, {k: torch.from_numpy(v) for k, v in batch.items()}))
        except Exception:  # the consumer raises it in the iteration that asked
            result_q.put((task_id, ("error", traceback.format_exc())))


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
        self._pool: dict | None = None
        self._task_seq = 0
        # the pool's results go to the iteration that asked for them: task
        # id -> (iteration, batch index); iteration -> {batch index: batch}
        self._iter_seq = 0
        self._pending: dict[int, tuple[int, int]] = {}
        self._results: dict[int, dict[int, object]] = {}

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

    def worker_pids(self) -> list[int]:
        """The process-mode pool's worker PIDs (none before its first epoch)."""
        return [] if self._pool is None else [p.pid for p in self._pool["procs"]]

    def _ensure_pool(self) -> dict:
        """The pool of worker processes, built now if there is none or one
        of its workers has died.  The dataset is pickled into each worker
        once, here, not each epoch."""
        pool = self._pool
        if pool is not None and all(p.is_alive() for p in pool["procs"]):
            return pool
        self.close()
        import torch.multiprocessing

        ctx = torch.multiprocessing.get_context("spawn")
        task_q, result_q = ctx.Queue(), ctx.Queue()
        procs = [ctx.Process(target=_process_worker, args=(self.dataset, task_q, result_q),
                             daemon=True) for _ in range(self.num_workers)]
        for p in procs:
            p.start()
        self._pool = {"procs": procs, "task_q": task_q, "result_q": result_q}
        return self._pool

    def close(self) -> None:
        """End the process-mode pool's workers (nothing to do without one)."""
        pool, self._pool = self._pool, None
        self._pending.clear()
        if pool is None:
            return
        for _ in pool["procs"]:
            pool["task_q"].put(None)
        try:  # drain what the workers still send, so that none blocks on a full pipe
            while True:
                pool["result_q"].get(timeout=0.1)
        except (queue.Empty, OSError, EOFError):
            pass
        for p in pool["procs"]:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for q in (pool["task_q"], pool["result_q"]):
            q.close()
            q.cancel_join_thread()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the queues' modules may be gone
            pass

    def _deliver(self, task_id: int, payload) -> None:
        """Hand a result to the iteration that asked for it; a result of an
        abandoned iteration (no longer pending) is dropped."""
        target = self._pending.pop(task_id, None)
        if target is not None:
            it, i = target
            results = self._results.get(it)
            if results is not None:
                results[i] = payload

    def _iter_processes(self, batches) -> Iterator[dict[str, np.ndarray]]:
        pool = self._ensure_pool()
        procs, task_q, result_q = pool["procs"], pool["task_q"], pool["result_q"]
        it = self._iter_seq
        self._iter_seq += 1
        results = self._results.setdefault(it, {})
        window = self.prefetch + self.num_workers
        submitted = 0

        def submit():
            nonlocal submitted
            self._pending[self._task_seq] = (it, submitted)
            task_q.put((self._task_seq, np.asarray(batches[submitted])))
            self._task_seq += 1
            submitted += 1

        try:
            while submitted < min(window, len(batches)):
                submit()
            for i in range(len(batches)):
                waited = 0.0
                while i not in results:
                    try:
                        self._deliver(*result_q.get(timeout=_POLL_S))
                        continue
                    except queue.Empty:
                        pass
                    dead = [p for p in procs if not p.is_alive()]
                    if dead:  # deliver what has arrived before deciding
                        try:
                            while True:
                                self._deliver(*result_q.get_nowait())
                        except queue.Empty:
                            pass
                        if i in results:
                            break
                        raise RuntimeError(f"DataLoader worker process {dead[0].pid} died "
                                           f"(exit code {dead[0].exitcode}) before batch {i} "
                                           "arrived; the next iteration starts a new pool")
                    waited += _POLL_S
                    if waited >= _STALL_S:
                        raise RuntimeError(f"DataLoader workers alive but silent for "
                                           f"{waited:.0f} s, waiting for batch {i}")
                if submitted < len(batches):
                    submit()
                item = results.pop(i)
                if isinstance(item, tuple):
                    raise RuntimeError(f"DataLoader worker failed:\n{item[1]}")
                yield {k: v.numpy() for k, v in item.items()}
        finally:
            self._results.pop(it, None)
            for tid in [t for t, (owner, _) in self._pending.items() if owner == it]:
                del self._pending[tid]
