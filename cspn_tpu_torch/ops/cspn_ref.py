"""Plain PyTorch CSPN (counterpart of cspn_tpu/ops/cspn_ref.py).

Two families, as in the JAX package:

1. `cspn2d_reference` is the pytorch "naive" 2D CSPN
   (cspn_pytorch/models/cspn.py:42-172): padded-canvas affinity
   normalization, `(1 - gate_sum) * x0` center coupling to the *initial*
   depth, and per-step sparse anchoring.  0/0 in the normalization is
   guarded to 0 (the reference gives NaN there; reachable only if all eight
   neighbor gates are exactly zero), as in the JAX package.
2. `affinity_propagate_reference` / `cspn_nd_reference`: the paddle native
   op and its module wrapper (cspn_paddle/demo.py:20-54), 2D or 3D, gates
   normalized per pixel outside the op and shared across the C channels of
   a group.  `propagate_nd_reference` is `steps` of those steps on fixed
   gates in the kernels' channel-first layout.

This module is the plain version of the Hopper kernels in ops/cspn_cuda.py
(2D), ops/cspn_halo_cuda.py (the sharded 2D CSPN's segment,
`halo_segment_reference`) and ops/cspn3d_cuda.py (3D): the CPU path runs
it, and chip_smoke.py holds the kernels against it on the card.  Everything here is
autograd-native and runs on any device.

Layout, as in the JAX package: guidance [N, H, W, 8] (channels last),
depth [N, H, W]; for the nd op guide [N, *spatial, C*(k^n-1)], feat
[N, *spatial, C].
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops.neighbors import OFFSETS_2D_REFERENCE, neighbor_offsets, shift

_VALID_NORMS = ("8sum", "8sum_abs")


def check_norm_type(norm_type: str) -> None:
    if norm_type not in _VALID_NORMS:
        raise ValueError(f"unknown norm_type {norm_type!r}; expected {_VALID_NORMS}")


def normalize_affinity_2d(guidance: torch.Tensor, norm_type: str = "8sum"):
    """Padded-canvas affinity normalization (cspn.py:85-144), gather form.

    Args:
        guidance: [N, H, W, 8] raw affinity head output, reference gate order.
        norm_type: '8sum' (signed affinities) or '8sum_abs' (abs first).

    Returns:
        gates:  [N, H, W, 8] normalized *pre-shifted* gates: gates[..., d]
                multiplies the depth value at `p + offset_d`.
        center: [N, H, W] center weight `1 - sum_d gates_d`.
    """
    check_norm_type(norm_type)
    g = guidance.abs() if norm_type == "8sum_abs" else guidance
    shifted = torch.stack(
        [shift(g[..., d], off, axes=(-2, -1)) for d, off in enumerate(OFFSETS_2D_REFERENCE)],
        dim=-1,
    )
    denom = shifted.abs().sum(dim=-1, keepdim=True)
    positive = denom > 0
    gates = torch.where(
        positive, shifted / torch.where(positive, denom, torch.ones_like(denom)), 0.0
    )
    center = 1.0 - gates.sum(dim=-1)
    return gates, center


def propagate_2d(
    gates: torch.Tensor,
    center: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_mask: torch.Tensor | None,
    steps: int,
) -> torch.Tensor:
    """Run `steps` propagation iterations with precomputed normalized gates.

    One step (cspn.py:66-82):
        x <- sum_d gates_d * x[p + offset_d] + center * x0
        x <- (1 - mask) * x + mask * x0        (sparse anchoring, if mask given)
    where x0 is the initial blur depth and mask = sign(sparse_depth).
    """
    x0 = blur_depth
    x = x0
    for _ in range(steps):
        y = center * x0
        for d, off in enumerate(OFFSETS_2D_REFERENCE):
            y = y + gates[..., d] * shift(x, off, axes=(-2, -1))
        if sparse_mask is not None:
            y = (1.0 - sparse_mask) * y + sparse_mask * x0
        x = y
    return x


def cspn2d_reference(
    guidance: torch.Tensor,
    blur_depth: torch.Tensor,
    sparse_depth: torch.Tensor | None = None,
    *,
    steps: int = 24,
    norm_type: str = "8sum",
) -> torch.Tensor:
    """Full 2D CSPN post-process, pytorch reference semantics (cspn.py:42-83).

    Args:
        guidance: [N, H, W, 8] affinity head output.
        blur_depth: [N, H, W] initial (blur) depth from the depth head.
        sparse_depth: optional [N, H, W] sparse observations; nonzero pixels
            are re-anchored to `blur_depth` after every step via
            mask = sign(sparse_depth).
        steps: prop_time (reference default 24).
        norm_type: '8sum' | '8sum_abs'.
    """
    gates, center = normalize_affinity_2d(guidance, norm_type)
    mask = torch.sign(sparse_depth) if sparse_depth is not None else None
    return propagate_2d(gates, center, blur_depth, mask, steps)


def halo_segment_reference(
    gates_cf: torch.Tensor,
    base: torch.Tensor,
    keep: torch.Tensor | None,
    x: torch.Tensor,
    k_steps: int,
) -> torch.Tensor:
    """`k_steps` fixed-gate steps on one halo-extended row block (the
    spatially sharded CSPN's local segment; counterpart of
    cspn_pallas.py:_halo_segment_ref).  One step:

        y = sum_d gates_d * x[p + offset_d]      (zero beyond the block)
        x = keep * y + base                      (y + base without keep)

    gates_cf [n, 8, He, W] normalized gather-form gates (reference order);
    base, keep, x [n, He, W].  Any float dtype, autograd-native.  The plain
    version of the kernels in ops/cspn_halo_cuda.py."""
    for _ in range(k_steps):
        y = sum(gates_cf[:, d] * shift(x, off, axes=(-2, -1))
                for d, off in enumerate(OFFSETS_2D_REFERENCE))
        x = keep * y + base if keep is not None else y + base
    return x


# --- parity helpers (reference cspn.py:175-194; unused by its forward path
# but part of its public class surface) -----------------------------------


def normalize_gate(guidance: torch.Tensor):
    """Two-gate abs-sum normalization (cspn.py:175-183): guidance [..., 2]
    split into two maps, each divided by |g1|+|g2|.  Like the reference,
    0/0 gives NaN here."""
    g1, g2 = guidance[..., 0], guidance[..., 1]
    s = g1.abs() + g2.abs()
    return g1 / s, g2 / s


def max_of_4_tensor(e1, e2, e3, e4):
    """Elementwise max of four maps (cspn.py:186-189)."""
    return torch.maximum(torch.maximum(e1, e2), torch.maximum(e3, e4))


def max_of_8_tensor(e1, e2, e3, e4, e5, e6, e7, e8):
    """Elementwise max of eight maps (cspn.py:191-194)."""
    return torch.maximum(max_of_4_tensor(e1, e2, e3, e4), max_of_4_tensor(e5, e6, e7, e8))


# --- paddle-semantics native op (2D/3D), per-pixel normalized gates -------


def affinity_propagate_reference(
    feat: torch.Tensor, gate_weight: torch.Tensor, kernel_size: int = 3
) -> torch.Tensor:
    """One propagation step, paddle `affinity_propagate` semantics.

    Args:
        feat: [N, *spatial, C] (spatial 2- or 3-dimensional).
        gate_weight: [N, *spatial, k^ndim - 1] per-pixel gates, already
            normalized along the last dim, shared across the C channels.

    out[p] = (1 - sum_d w_d[p]) * feat[p] + sum_d w_d[p] * feat[p + off_d],
    out-of-volume neighbours contributing zero (their gates still count in
    the center weight).
    """
    ndim = feat.ndim - 2
    offsets = neighbor_offsets(ndim, kernel_size)
    if gate_weight.shape[-1] != len(offsets):
        raise ValueError(
            f"gate_weight last dim {gate_weight.shape[-1]} != k^n-1 = {len(offsets)}"
        )
    axes = tuple(range(-ndim - 1, -1))  # spatial axes of feat [N, *S, C]
    out = (1.0 - gate_weight.sum(dim=-1))[..., None] * feat
    for d, off in enumerate(offsets):
        out = out + gate_weight[..., d : d + 1] * shift(feat, off, axes=axes)
    return out


def normalize_gates_nd(guide: torch.Tensor, n_gates: int) -> torch.Tensor:
    """abs, then sum-normalized per feature-channel group of `n_gates`
    (demo.py:24,34-36) with the max(sum, 1e-12) guard: guide [..., C*n_gates]
    -> gates [..., C, n_gates]."""
    a = guide.abs().unflatten(-1, (guide.shape[-1] // n_gates, n_gates))
    return a / a.sum(dim=-1, keepdim=True).clamp_min(1e-12)


def cspn_nd_reference(
    guide: torch.Tensor,
    feat: torch.Tensor,
    *,
    kernel_size: int = 3,
    steps: int = 24,
) -> torch.Tensor:
    """Multi-step nd CSPN module, paddle demo semantics (demo.py:20-54).

    Args:
        guide: [N, *spatial, C * (k^n - 1)] raw guidance; abs() then
            sum-normalized per feature-channel group.
        feat: [N, *spatial, C] features (e.g. a stereo cost volume).
    """
    ndim = feat.ndim - 2
    n_gates = kernel_size**ndim - 1
    c = feat.shape[-1]
    if guide.shape[-1] != c * n_gates:
        raise ValueError(f"guide channels {guide.shape[-1]} != C*(k^n-1) = {c * n_gates}")
    gates = normalize_gates_nd(guide, n_gates)
    offsets = neighbor_offsets(ndim, kernel_size)
    axes = tuple(range(-ndim - 1, -1))
    outs = []
    for ch in range(c):
        w = gates[..., ch, :]
        center = 1.0 - w.sum(dim=-1, keepdim=True)
        x = feat[..., ch : ch + 1]
        for _ in range(steps):
            y = center * x
            for d, off in enumerate(offsets):
                y = y + w[..., d : d + 1] * shift(x, off, axes=axes)
            x = y
        outs.append(x)
    return torch.cat(outs, dim=-1)


def propagate_nd_reference(
    gates: torch.Tensor, x: torch.Tensor, steps: int, kernel_size: int = 3
) -> torch.Tensor:
    """`steps` iterations of `affinity_propagate_reference` on fixed
    normalized gates, in the kernels' channel-first layout: gates
    [M, k^n - 1, *spatial], x [M, *spatial] -> [M, *spatial].  The plain
    version of the 3D kernels in ops/cspn3d_cuda.py."""
    g = gates.movedim(1, -1)
    y = x.unsqueeze(-1)
    for _ in range(steps):
        y = affinity_propagate_reference(y, g, kernel_size)
    return y.squeeze(-1)
