"""Host self time a call of the `epoch_step` wrapper's spans (argument
preparation and launch, reassembly), in ms."""
from perfbench.spans import self_ms


def read(ctx):
    return self_ms(ctx, lambda name, rec: name.startswith("epoch_step"))
