"""The Fig. 13 flit-level router simulation: one CUDA launch for T cycles of
B runs (port of `repro.kernels.noc_step`)."""
