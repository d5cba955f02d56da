"""cspn2d_tiled_roofline: the 2D CSPN forward that no backward follows
against its memory bound, in %: the frozen bytes a served frame's CSPN
must move (work/<config>.json, `serve`) times the frames served in the
traced window, over the card's HBM rate, divided by the device time of
the `cspn2d_tiled` kernels in the trace."""

from perfbench.harness.readers import roofline


def read(r):
    return roofline(r, "serve", ("cspn2d_tiled",))
