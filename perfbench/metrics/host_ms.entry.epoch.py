"""Host self time a call of the entry points' own spans (`sweep_batch`,
`summaries`; `search_codesign`, `codesign.result`), in ms."""
from perfbench.spans import self_ms


def read(ctx):
    return self_ms(ctx, lambda name, rec: rec["layer"] == "entry points")
