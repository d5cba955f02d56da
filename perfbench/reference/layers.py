"""The CSPN-UNet's layer list at published widths: every convolution with
its input and output channels, kernel, stride and whether it reads a
zero-insert unpooled map, and every batch norm, under the published
model's state-dict names (`torch_resnet_cspn_nyu.py:278-376`, torchvision's
ResNet names for the encoder).

The list drives three things: the shapes of the weights the benchmark
makes from its seed, the reference forward (reference/unet.py) and the
frozen operation counts (work/count.py).
"""

from __future__ import annotations

import dataclasses

# torchvision's ResNet depths: (block, blocks per stage)
ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}
EXPANSION = {"basic": 1, "bottleneck": 4}
STAGE_PLANES = (64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str  # the weight's key without ".weight"
    cin: int
    cout: int
    k: int
    stride: int = 1
    unpooled: bool = False  # reads a 2x zero-insert unpooled map


def ceil_half_chain(h: int, w: int, n: int = 5) -> list[tuple[int, int]]:
    """[(H, W), (H/2, W/2), ...]: the encoder's ceil-halving of 7x7/s2,
    3x3/s2 pool and 3x3/s2 convs, each giving ceil(n / 2)."""
    sizes = [(h, w)]
    for _ in range(n):
        h, w = -(-h // 2), -(-w // 2)
        sizes.append((h, w))
    return sizes


def blocks(arch: str):
    """Yield (stage, index, block kind, inplanes, planes, stride, downsample)."""
    kind, depths = ARCHS[arch]
    e = EXPANSION[kind]
    inplanes = 64
    for stage, (planes, n, stride) in enumerate(zip(STAGE_PLANES, depths, (1, 2, 2, 2)), start=1):
        for b in range(n):
            s = stride if b == 0 else 1
            ds = b == 0 and (s != 1 or inplanes != planes * e)
            yield stage, b, kind, inplanes, planes, s, ds
            inplanes = planes * e


def encoder_convs(arch: str, in_channels: int = 4) -> list[Conv]:
    kind, _ = ARCHS[arch]
    e = EXPANSION[kind]
    convs = [Conv("conv1_1", in_channels, 64, 7, 2)]
    for stage, b, kind, cin, planes, s, ds in blocks(arch):
        p = f"layer{stage}.{b}"
        if kind == "basic":
            convs += [Conv(f"{p}.conv1", cin, planes, 3, s), Conv(f"{p}.conv2", planes, planes, 3)]
        else:
            convs += [Conv(f"{p}.conv1", cin, planes, 1), Conv(f"{p}.conv2", planes, planes, 3, s),
                      Conv(f"{p}.conv3", planes, planes * e, 1)]
        if ds:
            convs.append(Conv(f"{p}.downsample.0", cin, planes * e, 1, s))
    convs.append(Conv("conv2", 512 * e, 512 * e, 3))
    return convs


def decoder_convs(arch: str) -> list[Conv]:
    e = EXPANSION[ARCHS[arch][0]]
    convs = []
    # (block, cin, side channels, features): Gudi_UpProj_Block, then three
    # Gudi_UpProj_Block_Cat taking skip2, skip3, skip4
    for i, (cin, side, feat) in enumerate(
            ((512 * e, 0, 256 * e), (256 * e, 128 * e, 128 * e), (128 * e, 64 * e, 64 * e),
             (64 * e, 64, 64)), start=1):
        p = f"gud_up_proj_layer{i}"
        convs.append(Conv(f"{p}.conv1", cin, feat, 5, unpooled=True))
        if side:
            convs.append(Conv(f"{p}.conv1_1", feat + side, feat, 3))
        convs += [Conv(f"{p}.conv2", feat, feat, 3), Conv(f"{p}.sc_conv1", cin, feat, 5, unpooled=True)]
    # the heads: blur depth (1 channel) and the 8 affinities
    convs += [Conv("gud_up_proj_layer5.conv1", 64, 1, 3, unpooled=True),
              Conv("gud_up_proj_layer6.conv1", 64, 8, 3, unpooled=True)]
    return convs


def convs(arch: str, in_channels: int = 4) -> list[Conv]:
    return encoder_convs(arch, in_channels) + decoder_convs(arch)


def batch_norms(arch: str) -> dict[str, int]:
    """{name: channels} of every batch norm."""
    kind, _ = ARCHS[arch]
    e = EXPANSION[kind]
    bns = {"bn1": 64}
    for stage, b, kind, cin, planes, s, ds in blocks(arch):
        p = f"layer{stage}.{b}"
        n_conv = 2 if kind == "basic" else 3
        for j in range(1, n_conv + 1):
            bns[f"{p}.bn{j}"] = planes * e if j == n_conv and kind == "bottleneck" else planes
        if ds:
            bns[f"{p}.downsample.1"] = planes * e
    bns["bn2"] = 512 * e
    for c in decoder_convs(arch):
        block, conv = c.name.rsplit(".", 1)
        if block in ("gud_up_proj_layer5", "gud_up_proj_layer6"):
            continue
        bn = {"conv1": "bn1", "conv1_1": "bn1_1", "conv2": "bn2", "sc_conv1": "sc_bn1"}[conv]
        bns[f"{block}.{bn}"] = c.cout
    return bns


def param_shapes(arch: str, in_channels: int = 4) -> dict[str, tuple[int, ...]]:
    """{state-dict key: shape} of every learned parameter (conv weights,
    bias-free; BN weight and bias)."""
    shapes = {f"{c.name}.weight": (c.cout, c.cin, c.k, c.k) for c in convs(arch, in_channels)}
    for name, ch in batch_norms(arch).items():
        shapes[f"{name}.weight"] = (ch,)
        shapes[f"{name}.bias"] = (ch,)
    return shapes
