"""Exchange accounting (counterpart of cspn_tpu/parallel/hlo_checks.py).

The JAX package counts the collective-permutes XLA emitted for the
sharded CSPN in the compiled HLO and pins them to the formulas below.
PyTorch compiles no HLO, so parallel/halo.py counts its exchange pairs
(`halo.exchanges`, one up and one down each) as they run, and the tests
and chip_smoke.py pin twice that count to the same formulas, copied here
(hlo_checks.py:28-44; tests/test_torch_spatial.py holds the copies equal
to the originals).
"""

from __future__ import annotations


def expected_ppermutes_2d(steps: int, k: int, has_sparse: bool = True) -> int:
    """Forward collective-permute count for cspn2d_spatial (parallel/halo.py):
    one (up, down) pair per initial exchange -- guidance, blur[, sparse] --
    plus one pair per halo refresh between the ceil(steps/k) segments.
    `k` is the EFFECTIVE halo: _local_cspn clamps it to the local shard
    extent minus one (a halo only reaches the immediate mesh neighbor)."""
    rounds = -(-steps // k)
    initial = 3 if has_sparse else 2
    return 2 * initial + 2 * (rounds - 1)


def expected_ppermutes_nd(steps: int, k: int) -> int:
    """Forward count for cspn_nd_spatial: gates + center + feat exchanges
    plus one pair per refresh."""
    rounds = -(-steps // k)
    return 2 * 3 + 2 * (rounds - 1)
