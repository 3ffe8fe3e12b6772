"""Replays of the captured co-design search a call, from the program's own
counter (`simulator.engine_stats()["codesign_graph_replays"]`): 1.0 where
every search of the window runs as one CUDA graph, 0 where each runs
eager. None for a program without the counter."""


def read(ctx):
    key = "codesign_graph_replays"
    if key not in ctx.counters_after or not ctx.calls:
        return None
    n = ctx.counters_after[key] - ctx.counters_before[key]
    return n / len(ctx.calls)
