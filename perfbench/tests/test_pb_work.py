"""The frozen work counts: equal to a fresh count of the layer list, and the
layer list at the published ResNet widths and operation counts."""

import json
import pathlib

import pytest
import torch

from perfbench.reference import layers
from perfbench.work import count

WORK = pathlib.Path(count.__file__).parent


@pytest.mark.parametrize("config", sorted(p.name for p in count.CONFIGS.glob("*.json")))
def test_frozen_counts_equal_a_fresh_count(config):
    frozen = json.loads((WORK / config).read_text())
    assert frozen == count.counts(json.loads((count.CONFIGS / config).read_text()))


@pytest.mark.parametrize("arch, macs, widths", [
    # torchvision's published multiply-adds at 224x224 (ResNet-50 4.09 G, ResNet-18 1.81 G,
    # the 1000-way classifier's 2.05 M / 0.51 M among them) and stage widths
    ("resnet50", 4.089e9 - 2.048e6, (256, 512, 1024, 2048)),
    ("resnet18", 1.814e9 - 0.512e6, (64, 128, 256, 512)),
])
def test_encoder_at_published_widths(arch, macs, widths):
    flops = count.conv_flops(arch, 224, 224, in_channels=3)
    trunk = sum(v for k, v in flops.items() if k.startswith(("conv1_1", "layer")))
    assert trunk / 2 == pytest.approx(macs, rel=2e-3)
    outs = {}
    for c in layers.encoder_convs(arch):
        if c.name.startswith("layer"):
            outs[int(c.name[5])] = c.cout
    assert tuple(outs[s] for s in (1, 2, 3, 4)) == widths


def test_unpooled_convs_count_nonzero_taps_only():
    # a 5x5 conv over a zero-insert unpooled 4-long axis: outputs 0..3 read
    # sources y-2..y+2, of which {0, 2} are non-zero: 2 + 2 + 2 + 1 taps
    assert count._taps_1d(4, 5, True) == 7
    assert count._taps_1d(4, 5, False) == 20


@pytest.mark.parametrize("arch, hw", [("resnet50", (228, 304)), ("resnet18", (352, 1216))])
def test_count_against_the_programs_modules(arch, hw):
    """FlopCounterMode over the program's subpixel model counts every tap of
    its phase convs, padding and cropped outputs included: at most ~8% above
    the non-zero taps, never below."""
    from torch.utils.flop_counter import FlopCounterMode

    from cspn_tpu_torch.models.unet import CSPNUNet

    kind, depths = layers.ARCHS[arch]
    with torch.device("meta"):
        model = CSPNUNet(block=kind, layers=depths, cspn_backend="reference").eval()
        counter = FlopCounterMode(display=False)
        with counter:
            model(torch.zeros(1, *hw, 4))
    ours = sum(count.conv_flops(arch, *hw).values())
    assert 1.0 < counter.get_total_flops() / ours < 1.1
