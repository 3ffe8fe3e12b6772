"""`epoch_step` launches per call of the window, from the program's own
counter (`simulator.engine_stats()["epoch_step_launches"]`)."""


def read(ctx):
    key = "epoch_step_launches"
    if key not in ctx.counters_after or not ctx.calls:
        return None
    n = ctx.counters_after[key] - ctx.counters_before[key]
    return n / len(ctx.calls)
