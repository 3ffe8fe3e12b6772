"""Share of the traced window in which no kernel, copy or fill ran on the
card (profiler)."""
from perfbench.trace import idle_share


def read(ctx):
    return idle_share(ctx.trace)
