"""Spatially sharded CSPN with halo exchange (counterpart of
cspn_tpu/parallel/halo.py).

The image's rows (the 2D CSPN) or the cost volume's depth (the nd CSPN)
are split into S blocks over a `Mesh` (parallel/mesh.py), and the 24-step
recurrence runs blockwise: a CSPN step needs a 1-pixel neighbourhood, so
with a halo of K rows every block runs K steps on its own before it
exchanges K edge rows with its neighbours.

Correctness, as in the JAX package:
  - the 2D gate normalization needs a 1-row guidance halo, so the raw
    guidance is exchanged K+1 rows deep, normalized on that block, and the
    gates cropped to the K-extended block;
  - the exchange's zero fill beyond the first and last block is the
    reference's zero padding at the image border;
  - halo rows run the same update as interior rows; their outermost rows
    go stale one row per step, so after K steps the interior is exact.

The 2D segments run `ops/cspn_halo_cuda.py:cspn2d_halo_segment` (the
Hopper kernels on CUDA tensors, the plain version on the CPU); the 3D
segments run `ops/cspn3d_cuda.py:propagate3d` at f32 gates, what JAX's
`_halo3_segment` asks for.  `fused=False` (and, as in JAX, the nd CSPN's
other ranks) runs the composed stencil in plain PyTorch.

`exchanges` counts the exchange pairs (one up, one down) the forward
makes on a mesh of more than one block: parallel/exchange_counts.py holds
the JAX package's collective-permute counts, which are twice these.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cspn_tpu_torch.ops import cspn_ref
from cspn_tpu_torch.ops.cspn3d_cuda import propagate3d
from cspn_tpu_torch.ops.cspn_halo_cuda import cspn2d_halo_segment
from cspn_tpu_torch.ops.neighbors import neighbor_offsets, shift
from cspn_tpu_torch.parallel.mesh import Mesh

exchanges = 0

# --- halo-width cost model (cspn_tpu/parallel/halo.py:choose_halo) ---------
#
# Per segment of K local steps a block pays the stencil on its 2K halo rows,
# one reload of the segment's input planes, a fixed cost per segment and one
# exchange.  Defaults for one NVIDIA H100 80GB HBM3 at 700 W:

# per pixel-step: cspn2d_halo_seg (the column march, 12 steps a launch) on
# the KITTI b4 S = 2 segment, K = 24 on [8,8,224,1216], CUDA events
# (chip_smoke.py phase 3: 4.098 and 4.495 ps in two runs; 5.92 ps at K = 8
# on [8,8,192,1216], chip_smoke.py --routes-of; 6.3 ps for the earlier
# 32x32 tile kernel)
T2D_STEP_S_PER_PX = 4.1e-12
# per voxel-step: cspn3d_fwd fitted as fixed + per step (chip_smoke.py
# phase 3), the median of four fits: 18.0 and 19.5 ps through 4 and 24 steps
# on [4,26,48,64,128], 19.3 and 24.1 ps through 4 and 8 on the sharded
# stereo segment [8,26,40,64,128].  The fixed part is the gates' load, the
# reload term below.
T3D_STEP_S_PER_VOX = 19.4e-12
HBM_BPS = 3.35e12  # NVIDIA's data sheet, H100 SXM
# host time of a segment beyond its stencil: the exchange's copies, the
# wrapper and its launches, eager PyTorch (chip_smoke.py:segment_fixed_s,
# 90-191 us from run to run, 169 and 206 us with the column march's
# segment, whose host work is the earlier one's: host time on a shared
# host varies)
SEG_FIXED_S = 99.5e-6
# The link terms: one card has no link to measure, so these are parameters,
# NVLink's data-sheet rate each way and an assumed latency, not measurements.
LINK_BPS = 450e9
LINK_LAT_S = 10e-6


def choose_halo(
    steps: int,
    shard_extent: int,
    plane_px: int,
    batch: int,
    *,
    n_gate_planes: int = 8,
    t_step: float = T2D_STEP_S_PER_PX,
    hbm_bps: float = HBM_BPS,
    seg_fixed_s: float = SEG_FIXED_S,
    link_bps: float = LINK_BPS,
    link_lat_s: float = LINK_LAT_S,
) -> int:
    """The halo width K in [1, min(steps, shard_extent - 1)] that minimizes

        T(K) = steps * ext * plane_px * batch * t_step
               + ceil(steps / K) * (reload + seg_fixed_s + exchange),
        ext = shard_extent + 2K,
        reload = (n_gate_planes + 3) * ext * plane_px * batch * 4 / hbm_bps,
        exchange = link_lat_s + 2K * plane_px * batch * 4 / link_bps.

    shard_extent: a block's length along the sharded axis (rows in 2D, D in
    3D); plane_px: pixels per unit of it (W in 2D, H*W in 3D).  The JAX
    package's model with its constants as parameters; unlike JAX, training
    passes no predicate (there is no VMEM fit to respect), so its K can
    differ from JAX's there."""
    k_max = max(1, min(steps, shard_extent - 1))
    best_k, best_t = 1, float("inf")
    for k in range(1, k_max + 1):
        rounds = -(-steps // k)
        ext = shard_extent + 2 * k
        compute = steps * ext * plane_px * batch * t_step
        reload = (n_gate_planes + 3) * ext * plane_px * batch * 4 / hbm_bps
        comm = link_lat_s + 2 * k * plane_px * batch * 4 / link_bps
        t = compute + rounds * (reload + seg_fixed_s + comm)
        if t < best_t:
            best_k, best_t = k, t
    return best_k


def effective_halo(halo: int | None, steps: int, shard_extent: int, plane_px: int, batch: int,
                   **cost) -> int:
    """The K a block runs: `halo`, or choose_halo's when None, capped to the
    block's extent minus one (a halo, and the 2D +1 gate halo, reaches only
    the adjacent block)."""
    if shard_extent < 2:
        raise ValueError(f"a block of {shard_extent} row(s) cannot take a halo")
    if halo is None:
        halo = choose_halo(steps, shard_extent, plane_px, batch, **cost)
    return max(1, min(halo, shard_extent - 1))


def _exchange_halos(x: torch.Tensor, k: int, mesh: Mesh) -> torch.Tensor:
    """Extend rows (dim 1) of each local block with k rows from each
    neighbour; zeros beyond the first and last block."""
    global exchanges
    if mesh.spatial == 1:
        return F.pad(x, [0, 0] * (x.ndim - 2) + [k, k])
    exchanges += 1
    return mesh.exchange(x, k)


def _segment_inputs(guidance, blur, sparse, *, steps, norm_type, halo, mesh):
    """One process's blocks (guidance [b, h, W, 8], blur/sparse [b, h, W]) to
    the first segment's inputs, each K-extended: (gates_cf [b, 8, h + 2K, W],
    base, keep or None, x0, K)."""
    h, w = blur.shape[1:]
    k = effective_halo(halo, steps, h, w, blur.shape[0] // mesh.local_blocks)
    g_ext = _exchange_halos(guidance, k + 1, mesh)
    gates, center = cspn_ref.normalize_affinity_2d(g_ext, norm_type)
    gates, center = gates[:, 1:-1], center[:, 1:-1]  # valid on the K-extended block

    x0 = _exchange_halos(blur, k, mesh)
    if sparse is not None:
        mask = torch.sign(_exchange_halos(sparse, k, mesh))
        keep = 1.0 - mask
        base = keep * center * x0 + mask * x0
    else:
        keep = None
        base = center * x0
    gates_cf = gates.movedim(-1, 1).contiguous()  # [b, 8, h + 2K, W], once
    return gates_cf, base, keep, x0, k


def _local_cspn(guidance, blur, sparse, *, steps, norm_type, halo, mesh, fused):
    """One process's blocks: guidance [b, h, W, 8], blur/sparse [b, h, W]."""
    gates_cf, base, keep, x, k = _segment_inputs(guidance, blur, sparse, steps=steps,
                                                 norm_type=norm_type, halo=halo, mesh=mesh)
    segment = cspn2d_halo_segment if fused else cspn_ref.halo_segment_reference
    done = 0
    while done < steps:
        if done:  # refresh the halo rows from the neighbours' interiors
            x = _exchange_halos(x[:, k:-k], k, mesh)
        k_this = min(k, steps - done)
        x = segment(gates_cf, base, keep, x, k_this)
        done += k_this
    return x[:, k:-k]


def _split_2d(guidance, blur_depth, sparse_depth, mesh, channel_first):
    g = guidance.movedim(1, -1) if channel_first else guidance
    return [None if t is None else mesh.split_rows(t) for t in (g, blur_depth, sparse_depth)]


def cspn2d_spatial(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    mesh: Mesh,
    steps: int = 24,
    norm_type: str = "8sum",
    halo: int | None = None,
    fused: bool = True,
    channel_first: bool = False,
) -> torch.Tensor:
    """2D CSPN with the image rows split over `mesh`; the function of
    ops.cspn.cspn2d (pytorch reference semantics).

    guidance [N, H, W, 8] ([N, 8, H, W] with channel_first), blur_depth and
    sparse_depth [N, H, W]; H must split into mesh.spatial blocks.  halo=None
    picks K per block shape (choose_halo; the JAX package's `training`
    predicate, a VMEM fit, has no counterpart here).  fused=False runs the
    plain composed segment on every device."""
    cspn_ref.check_norm_type(norm_type)
    g, b, s = _split_2d(guidance, blur_depth, sparse_depth, mesh, channel_first)
    out = _local_cspn(g, b, s, steps=steps, norm_type=norm_type, halo=halo, mesh=mesh,
                      fused=fused)
    return mesh.join_rows(out)


def first_segment_inputs(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    mesh: Mesh,
    steps: int = 24,
    norm_type: str = "8sum",
    halo: int | None = None,
    channel_first: bool = False,
):
    """What cspn2d_spatial (same arguments) hands its first segment on this
    process's blocks (an in-process mesh stacks its S blocks along the
    batch): (gates_cf [b, 8, h + 2K, W], base, keep or None, x0, K).  For
    checking the segment kernels at the path's shapes and values."""
    cspn_ref.check_norm_type(norm_type)
    g, b, s = _split_2d(guidance, blur_depth, sparse_depth, mesh, channel_first)
    return _segment_inputs(g, b, s, steps=steps, norm_type=norm_type, halo=halo, mesh=mesh)


def _local_cspn_nd(guide, feat, *, kernel_size, steps, halo, mesh, fused):
    """One process's blocks of the paddle-semantics nd CSPN: guide [b, d, *rest,
    C*(k^n-1)], feat [b, d, *rest, C], the first spatial axis split.  The
    gates are normalized per pixel, so unlike the 2D canvas form they need
    no +1 halo: gates, centre and features are exchanged K deep."""
    ndim = feat.ndim - 2
    n_gates = kernel_size**ndim - 1
    c = feat.shape[-1]
    offsets = neighbor_offsets(ndim, kernel_size)
    axes = tuple(range(-ndim - 1, -1))
    k = effective_halo(halo, steps, feat.shape[1], math.prod(feat.shape[2:-1]),
                       feat.shape[0] // mesh.local_blocks * c, n_gate_planes=n_gates,
                       t_step=T3D_STEP_S_PER_VOX if ndim == 3 else T2D_STEP_S_PER_PX)

    g = cspn_ref.normalize_gates_nd(guide, n_gates)  # [b, d, *rest, C, n_gates]
    center = 1.0 - g.sum(dim=-1)
    # the centre is exchanged on every path, as in JAX's trace, so the
    # exchange count is one formula (exchange_counts.expected_ppermutes_nd)
    w = _exchange_halos(g, k, mesh)
    center = _exchange_halos(center, k, mesh)
    x = _exchange_halos(feat, k, mesh)

    if fused and ndim == 3 and kernel_size == 3:
        # the 3D kernels' layout, once: the C channels folded into the volumes
        b = x.shape[0]
        w_cf = w.permute(0, 4, 5, 1, 2, 3).flatten(0, 1).contiguous()  # [b*C, 26, d+2K, H, W]

        def run_segment(x, k_this):
            xm = x.movedim(-1, 1).flatten(0, 1).contiguous()
            return propagate3d(w_cf, xm, steps=k_this).unflatten(0, (b, c)).movedim(1, -1)

    else:

        def run_segment(x, k_this):
            for _ in range(k_this):
                y = center * x
                for d, off in enumerate(offsets):
                    y = y + w[..., d] * shift(x, off, axes=axes)
                x = y
            return x

    done = 0
    while done < steps:
        if done:
            x = _exchange_halos(x[:, k:-k], k, mesh)
        k_this = min(k, steps - done)
        x = run_segment(x, k_this)
        done += k_this
    return x[:, k:-k]


def cspn_nd_spatial(
    guide: torch.Tensor,
    feat: torch.Tensor,
    *,
    mesh: Mesh,
    kernel_size: int = 3,
    steps: int = 24,
    halo: int | None = None,
    fused: bool = True,
    channel_first: bool = False,
) -> torch.Tensor:
    """Paddle-semantics nd CSPN (ops.cspn.cspn_nd) with the first spatial
    axis (D of a stereo cost volume) split over `mesh`.

    guide [N, *spatial, C*(k^n-1)], feat [N, *spatial, C] ([N, C*(k^n-1),
    *spatial] and [N, C, *spatial] with channel_first); the first spatial
    axis must split into mesh.spatial blocks.  3D volumes with kernel 3 run
    their segments on the 3D kernels (the plain version on the CPU); other
    ranks, and fused=False, the composed stencil."""
    g = guide.movedim(1, -1) if channel_first else guide
    f = feat.movedim(1, -1) if channel_first else feat
    out = mesh.join_rows(_local_cspn_nd(mesh.split_rows(g), mesh.split_rows(f),
                                        kernel_size=kernel_size, steps=steps, halo=halo,
                                        mesh=mesh, fused=fused))
    return out.movedim(-1, 1) if channel_first else out
