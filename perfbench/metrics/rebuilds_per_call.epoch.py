"""Kernel builds and selection-table and co-design topology cache misses a
call of the window (each should read 0 once set-up has warmed them)."""
from perfbench.spans import rebuilds


def read(ctx):
    return rebuilds(ctx)
