"""Inputs made from the seed on the device, in a few large calls.

A frame is RGB-D [H, W, 4] with a dense depth label [H, W]: the label a
smooth field of 0.5-10 m (bilinear from a coarse random grid) with 5% of
its pixels invalid (0), the RGB channels uniform in [0, 1), channel 3 the
sparse depth, `n_sample` valid label pixels drawn without replacement and
zero elsewhere, as the reference's loaders sample it.  The same seed and
stream give the same frames on the same device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# streams of one seed: each use draws from its own generator
WEIGHTS, POOL, BATCHES = range(3)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (2**63 - 1))


@torch.no_grad()
def frames(n: int, h: int, w: int, n_sample: int, gen: torch.Generator, device):
    """(rgbd [n, h, w, 4], depth [n, h, w]), float32 on `device`."""
    coarse = torch.rand((n, 1, h // 16 + 2, w // 16 + 2), generator=gen, device=device)
    depth = 0.5 + 9.5 * F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    depth = torch.where(torch.rand((n, h, w), generator=gen, device=device) < 0.05, 0.0, depth)
    rgb = torch.rand((n, h, w, 3), generator=gen, device=device)
    score = torch.rand((n, h * w), generator=gen, device=device)
    score = torch.where(depth.reshape(n, -1) > 0, score, -1.0)
    idx = score.topk(n_sample, dim=1).indices
    sparse = torch.zeros((n, h * w), device=device)
    sparse.scatter_(1, idx, depth.reshape(n, -1).gather(1, idx))
    return torch.cat([rgb, sparse.view(n, h, w, 1)], -1), depth
