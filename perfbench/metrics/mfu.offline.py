"""mfu.offline: the frozen convolution FLOPs of a frame's forward
(work/<config>.json) times the frames served in the traced window, over
the window's seconds and the card's dense bf16 peak, in %.  The
denominator is the same whichever numeric path the server takes."""

from perfbench.harness.readers import flops_share


def read(r):
    return flops_share(r, "forward", "bf16_flops")
