"""Turnaround of one DSE call: the 95th percentile over every call of the
window, from its start to its results on the host (host clock)."""
import numpy as np


def read(ctx):
    ms = [(c.t1 - c.t0) * 1e3 for c in ctx.calls if c.info]
    return float(np.percentile(ms, 95)) if ms else None
