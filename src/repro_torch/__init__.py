"""ReSiPI reproduction in PyTorch for NVIDIA Hopper (H100).

The port of the JAX package `repro`, module for module: `core/` holds the
epoch-level simulator and its models, `kernels/` the hand-written CUDA
kernels with their plain PyTorch versions (`epoch_step`, and `noc_step`
for the Fig. 13 flit-level model), `random` a bit-exact twin of jax's
threefry PRNG, `interop` the numpy bridges the parity tests use, and
`figures` the paper's Figs. 10-13. `configs/` and `models/` serve the ten
LLMs of the seed's scaffolding (dense, MoE, VLM, SSM, hybrid and
encoder-decoder families) through the `flash_attention` and `ssd_scan`
kernels. `serve/` is the session server
(admission, retry, degradation, self-healing through the device placement
search) and `launch/serve.py` its command-line launcher. It imports torch
and numpy only; entry points run on the card by default (`backend`).
"""
