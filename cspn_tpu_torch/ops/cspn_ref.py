"""Plain PyTorch 2D CSPN (counterpart of cspn_tpu/ops/cspn_ref.py:38-118).

`cspn2d_reference` is the pytorch "naive" 2D CSPN
(cspn_pytorch/models/cspn.py:42-172): padded-canvas affinity normalization,
`(1 - gate_sum) * x0` center coupling to the *initial* depth, and per-step
sparse anchoring.  0/0 in the normalization is guarded to 0 (the reference
gives NaN there; reachable only if all eight neighbor gates are exactly
zero), as in the JAX package.

This module is the plain version of the Hopper kernel in ops/cspn_cuda.py:
the CPU path runs it, and chip_smoke.py holds the kernel against it on the
card.  Everything here is autograd-native and runs on any device.

Layout, as in the JAX package: guidance [N, H, W, 8] (channels last),
depth [N, H, W].
"""

from __future__ import annotations

import torch

from cspn_tpu_torch.ops.neighbors import OFFSETS_2D_REFERENCE, shift

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
