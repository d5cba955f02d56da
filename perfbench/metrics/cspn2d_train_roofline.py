"""cspn2d_train_roofline: the 2D CSPN's forward and backward in a train
step against their memory bound, in %: the frozen bytes they must move
whatever route runs (work/<config>.json, `train`) times the frames of the
traced steps, over the card's HBM rate, divided by the device time of
every 2D CSPN kernel in the trace (the forwards and the backward)."""

from perfbench.harness.readers import roofline


def read(r):
    return roofline(r, "train", ("cspn2d_fwd", "cspn2d_tiled", "cspn2d_bwd"))
