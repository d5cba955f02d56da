"""mfu.train: the frozen convolution FLOPs of a frame's train step (3 x the
forward, work/<config>.json) times the frames of the steps in the traced
window, over the window's seconds and the card's IEEE float32 peak
(outside the tensor cores: the cells' precision, TF32 off), in %."""

from perfbench.harness.readers import flops_share


def read(r):
    return flops_share(r, "train", "fp32_flops")
