"""Host self time a call of the `noc_step` wrapper's spans (`prepare` with
its routing, the launch), in ms."""
from perfbench.spans import self_ms


def read(ctx):
    return self_ms(ctx, lambda name, rec: name.startswith("noc_step"))
