"""The whole call's share of the card's roofline: the window's calls'
summed counted least time (the simulated work at the f32 CUDA-core and
HBM peaks) over their summed wall time, in percent."""


def read(ctx):
    return ctx.bound_share()
