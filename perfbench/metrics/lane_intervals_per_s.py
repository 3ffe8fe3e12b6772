"""Simulated design-point intervals per second: lanes x intervals of every
call completed in the window, over the window's length (host clock)."""


def read(ctx):
    work = ctx.work("lane_intervals")
    return None if work is None else work / ctx.window_s
