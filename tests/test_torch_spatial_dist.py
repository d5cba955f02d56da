"""The spatial mesh across processes (parallel/mesh.py, process-group mode)
and the multi-process runtime (parallel/distributed.py), on the CPU.

Two processes join a gloo group through a `file://` store under the test's
tmp_path (so parallel test workers cannot clash on ports), each runs the
sharded 2D and 3D CSPN on its row block of the same inputs with halo
exchange over torch.distributed P2P, and writes its output and gradients;
both must equal the in-process mesh's (the same blocks in one process), in
float64 to 1e-12: the exchange moves values and its backward adds the
returned halo cotangents, which may sum in another order.  The processes
import no JAX; the group's init has a bounded timeout and the test joins
them with one.
"""

import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from cspn_tpu_torch.parallel import cspn2d_spatial, cspn_nd_spatial, make_mesh
from cspn_tpu_torch.parallel.distributed import host_shard, initialize_multihost

_ROOT = pathlib.Path(__file__).resolve().parent.parent
F64 = torch.float64

_WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, sys.argv[3])
    from cspn_tpu_torch.parallel import cspn2d_spatial, cspn_nd_spatial, make_mesh
    from cspn_tpu_torch.parallel import halo
    from cspn_tpu_torch.parallel.distributed import host_shard, initialize_multihost

    rank, tmp = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    initialize_multihost(f"file://{tmp}/store", world_size=2, rank=rank, backend="gloo",
                         retries=1, timeout_s=60)
    assert host_shard() == (rank, 2), host_shard()
    inp = torch.load(f"{tmp}/inputs.pt")
    mesh = make_mesh(spatial=2, group=dist.group.WORLD)
    out = {}
    g, b = inp["g"].requires_grad_(True), inp["b"].requires_grad_(True)
    y = cspn2d_spatial(g, b, inp["s"], mesh=mesh, steps=7, halo=2)
    out["2d"] = (y.detach(), *torch.autograd.grad((y * inp["ct"]).sum(), (g, b)))
    gv, fv = inp["guide"].requires_grad_(True), inp["feat"].requires_grad_(True)
    y = cspn_nd_spatial(gv, fv, mesh=mesh, steps=5, halo=2)
    out["3d"] = (y.detach(), *torch.autograd.grad((y * inp["ct3"]).sum(), (gv, fv)))
    out["exchanges"] = halo.exchanges
    torch.save(out, f"{tmp}/out{rank}.pt")
    dist.destroy_process_group()
""")


def _run(mesh, inp):
    out = {}
    g, b = inp["g"].clone().requires_grad_(True), inp["b"].clone().requires_grad_(True)
    y = cspn2d_spatial(g, b, inp["s"], mesh=mesh, steps=7, halo=2)
    out["2d"] = (y.detach(), *torch.autograd.grad((y * inp["ct"]).sum(), (g, b)))
    gv, fv = inp["guide"].clone().requires_grad_(True), inp["feat"].clone().requires_grad_(True)
    y = cspn_nd_spatial(gv, fv, mesh=mesh, steps=5, halo=2)
    out["3d"] = (y.detach(), *torch.autograd.grad((y * inp["ct3"]).sum(), (gv, fv)))
    return out


def test_process_group_exchange_equals_in_process(tmp_path):
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=F64)  # noqa: E731
    inp = {"g": t(2, 12, 10, 8), "b": t(2, 12, 10), "ct": t(2, 12, 10),
           "s": torch.tensor((rng.random((2, 12, 10)) < 0.1) * 2.0, dtype=F64),
           "guide": t(1, 8, 4, 6, 26), "feat": t(1, 8, 4, 6, 1), "ct3": t(1, 8, 4, 6, 1)}
    torch.save(inp, tmp_path / "inputs.pt")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), str(tmp_path), str(_ROOT)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(_ROOT))
             for rank in (0, 1)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, (rank, err[-3000:])
    want = _run(make_mesh(spatial=2), inp)
    for rank in (0, 1):
        got = torch.load(tmp_path / f"out{rank}.pt")
        # 2D: guidance K+1 deep, blur, sparse, then a refresh per later
        # segment (ceil(7/2) = 4 segments); 3D: gates, centre, features
        # and 2 refreshes
        assert got["exchanges"] == (3 + 3) + (3 + 2)
        for key in ("2d", "3d"):
            for name, a, e in zip(("out", "d first", "d second"), got[key], want[key]):
                torch.testing.assert_close(a, e, rtol=1e-12, atol=1e-12,
                                           msg=f"rank {rank} {key} {name}")


def test_single_process_is_a_no_op():
    initialize_multihost()
    initialize_multihost(world_size=1)
    assert host_shard() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_unreachable_rendezvous_fails_fast():
    """A rank that waits for a store nobody serves gives up within its
    timeout and raises, retries exhausted."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # nothing listens here once closed
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, ValueError)):
        initialize_multihost(f"tcp://127.0.0.1:{port}", world_size=2, rank=1, backend="gloo",
                             retries=2, retry_delay_s=0.1, timeout_s=2)
    assert time.monotonic() - t0 < 60
    assert not torch.distributed.is_initialized()
