"""Host self time a call of the models-and-tables spans (`stack_traces`,
`epoch_inputs`, `selection_tables`; `codesign.*` but the result,
`topology.*`), in ms."""
from perfbench.spans import self_ms


def read(ctx):
    return self_ms(ctx,
                   lambda name, rec: rec["layer"] == "models and tables")
