"""The process-mode loader's persistent pool (cspn_tpu_torch/data/loader.py)
against the JAX package's semantics (cspn_tpu/data/loader.py:12-25,
179-300): one pool of spawned workers serves every epoch; a worker killed
between epochs, or dying in one, gives a new pool at the next iteration;
an abandoned epoch leaves the next one's batches right; the batches equal
the thread mode's and JAX's loader's for the same seed; `close()` ends
the workers.  On the CPU, at 8x12 synthetic frames."""

import os
import signal
import time

import numpy as np
import pytest

from cspn_tpu.data import DataLoader as JDataLoader
from cspn_tpu.data import SyntheticDepthDataset as JSyntheticDepthDataset
from cspn_tpu_torch.data import DataLoader, SyntheticDepthDataset

KW = dict(shuffle=True, drop_last=True, num_workers=2, seed=7)


def _ds():
    return SyntheticDepthDataset(length=10, hw=(8, 12), n_sample=8, seed=3)


class _DiesWhileFlagged:
    """A dataset whose worker exits at once while `flag` exists."""

    def __init__(self, flag: str):
        self.flag, self.ds = flag, _ds()

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if os.path.exists(self.flag):
            os._exit(3)
        return self.ds[i]


def _same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def _gone(pid: int, timeout: float = 10.0) -> bool:
    """The worker (a child of this process) has exited: reaped already, or
    waitable, which waitid sees without reaping it (its Process does)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if os.waitid(os.P_PID, pid, os.WEXITED | os.WNOWAIT | os.WNOHANG) is not None:
                return True
        except ChildProcessError:
            return True
        time.sleep(0.05)
    return False


def test_one_pool_serves_every_epoch_and_drops_an_abandoned_one():
    """Built at the first epoch, one pool of 2 workers serves every epoch
    with the thread mode's and JAX's batches; an epoch abandoned after one
    batch (four more were asked for, and are dropped on arrival) leaves the
    next epochs right; close() ends the workers."""
    loader = DataLoader(_ds(), 2, worker_mode="process", **KW)
    threads = DataLoader(_ds(), 2, worker_mode="thread", **KW)
    jax_loader = JDataLoader(JSyntheticDepthDataset(length=10, hw=(8, 12), n_sample=8, seed=3),
                             2, **KW)
    try:
        assert loader.worker_pids() == []
        got = list(loader)
        pids = loader.worker_pids()
        assert len(pids) == 2
        _same(got, list(threads))
        _same(got, list(jax_loader))
        epoch = iter(loader)
        first = next(epoch)
        epoch.close()
        _same([first], list(threads)[:1])
        list(jax_loader)
        for _ in range(2):
            got = list(loader)
            _same(got, list(threads))
            _same(got, list(jax_loader))
            assert loader.worker_pids() == pids
    finally:
        loader.close()
    assert loader.worker_pids() == [] and all(_gone(p) for p in pids)


def test_dead_workers_raise_in_their_epoch_and_the_next_builds_a_pool(tmp_path):
    """A worker killed between epochs: the next epoch runs on a new pool
    (the old pool's survivor ended).  A worker that dies in an epoch
    (exits while the flag file exists): that epoch raises, and the next
    one runs on a new pool, with the thread mode's batches throughout."""
    flag = tmp_path / "die"
    ld = DataLoader(_DiesWhileFlagged(str(flag)), 2, worker_mode="process", **KW)
    threads = DataLoader(_ds(), 2, worker_mode="thread", **KW)
    try:
        _same(list(ld), list(threads))
        old = ld.worker_pids()
        os.kill(old[0], signal.SIGKILL)
        assert _gone(old[0])
        _same(list(ld), list(threads))
        new = ld.worker_pids()
        assert len(new) == 2 and not set(new) & set(old) and _gone(old[1])
        flag.touch()
        with pytest.raises(RuntimeError, match="worker process .* died"):
            list(ld)
        list(threads)  # the epoch the loader lost
        flag.unlink()
        _same(list(ld), list(threads))
        assert not set(ld.worker_pids()) & set(new)
    finally:
        ld.close()
