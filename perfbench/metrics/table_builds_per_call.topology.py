"""Builds of the padded selection tables' device view a call of the
window, from the program's own counter
(`simulator.engine_stats()["padded_table_builds"]`, each miss of its
cache): 0 once set-up has built the grid's tables. None for a program
without the counter."""
from perfbench.spans import per_call


def read(ctx):
    key = "padded_table_builds"
    return per_call(ctx, (key,), lambda stats: stats[key])
