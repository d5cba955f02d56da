"""The model's weights made from the seed on the device.

Every convolution weight is He-normal (std sqrt(2 / fan_in)), drawn in
one call for all of them and clipped at 2 standard deviations; batch-norm
scales are 1 and shifts 0.  The result is a dict of float32 views of one
buffer, keyed as the published state dict (reference/layers.py), which
the benchmark hands to the program and to the reference alike.
"""

from __future__ import annotations

import math

import torch

from perfbench.harness import data
from perfbench.reference import layers


@torch.no_grad()
def make(arch: str, seed: int, device, in_channels: int = 4) -> dict[str, torch.Tensor]:
    shapes = layers.param_shapes(arch, in_channels)
    convs = [k for k, s in shapes.items() if len(s) == 4]
    numels = [math.prod(shapes[k]) for k in convs]
    std = torch.tensor([math.sqrt(2.0 / math.prod(shapes[k][1:])) for k in convs], device=device)
    flat = torch.randn(sum(numels), generator=data.generator(seed, data.WEIGHTS, device),
                       device=device)
    flat.clamp_(-2.0, 2.0).mul_(torch.repeat_interleave(std, torch.tensor(numels, device=device)))
    out = {k: t.view(shapes[k]) for k, t in zip(convs, flat.split(numels))}
    norms = [k for k, s in shapes.items() if len(s) == 1]
    ones = torch.ones(sum(shapes[k][0] for k in norms), device=device)
    for k, t in zip(norms, ones.split([shapes[k][0] for k in norms])):
        out[k] = t if k.endswith(".weight") else torch.zeros_like(t)
    return {k: out[k] for k in shapes}
