"""Neighborhood geometry shared by the CSPN ops (counterpart of
cspn_tpu/ops/neighbors.py).

Propagation is written in *gather* form: for an output pixel p, direction d
contributes the value at source pixel ``p + offset_d`` (zero if outside the
image).  `OFFSETS_2D_REFERENCE` keeps the reference model's gate1..gate8
channel order (cspn_pytorch/models/cspn.py:100-129):

    gate1 left-top      -> source offset (+1, +1)
    gate2 center-top    -> source offset (+1,  0)
    gate3 right-top     -> source offset (+1, -1)
    gate4 left-center   -> source offset ( 0, +1)
    gate5 right-center  -> source offset ( 0, -1)
    gate6 left-bottom   -> source offset (-1, +1)
    gate7 center-bottom -> source offset (-1,  0)
    gate8 right-bottom  -> source offset (-1, -1)
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch
import torch.nn.functional as F


def neighbor_offsets(ndim: int, kernel: int = 3) -> tuple[tuple[int, ...], ...]:
    """All k^ndim - 1 non-center offsets of a centered k-cube, raster order
    (the order of the paddle-style nd op; the 2D pytorch-semantics op uses
    `OFFSETS_2D_REFERENCE` instead)."""
    r = kernel // 2
    return tuple(
        o
        for o in itertools.product(range(-r, r + 1), repeat=ndim)
        if any(c != 0 for c in o)
    )


# Reference gate order for the 2D pytorch-semantics op (see module docstring).
OFFSETS_2D_REFERENCE: tuple[tuple[int, int], ...] = (
    (1, 1), (1, 0), (1, -1),
    (0, 1), (0, -1),
    (-1, 1), (-1, 0), (-1, -1),
)


def shift(x: torch.Tensor, offset: Sequence[int], axes: Sequence[int]) -> torch.Tensor:
    """Gather-shift: y[idx] = x[idx + offset] along `axes`, zero outside.

    offset[i] applies to axes[i].  Positive offset pulls from larger indices.
    """
    if len(offset) != len(axes):
        raise ValueError(f"{len(offset)} offsets for {len(axes)} axes")
    pads = [0] * (2 * x.ndim)  # F.pad order: last dim first, (lo, hi) pairs
    for off, ax in zip(offset, axes):
        ax = ax % x.ndim
        k = 2 * (x.ndim - 1 - ax)
        pads[k], pads[k + 1] = max(-off, 0), max(off, 0)
    y = F.pad(x, pads)
    for off, ax in zip(offset, axes):
        ax = ax % x.ndim
        y = y.narrow(ax, max(off, 0), x.shape[ax])
    return y
