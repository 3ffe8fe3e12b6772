"""Blockwise online-softmax attention: one CUDA launch per prefill attention
call (port of `repro.kernels.flash_attention`)."""
