"""Device-to-host reads a call the program counts
(`engine_stats()["host_reads"]`)."""
from perfbench.spans import host_reads


def read(ctx):
    return host_reads(ctx)
