"""Host self time a call of the padded entry points' input stages
(`topology.prepare`, `.trace_arrays`, `.lanes`, `.dest_pairs`,
`.initial_state` of `simulator.topology_inputs`), in ms."""
from perfbench.spans import self_ms


def read(ctx):
    return self_ms(ctx, lambda name, rec: name.startswith("topology."))
