"""The fused RESIPI interval loop: one CUDA launch for T intervals of B
lanes (port of `repro.kernels.epoch_step`)."""
