"""Hand-written Hopper kernels of the port, one folder each: `csrc/` (CUDA
C++ for sm_90a), `ops.py` (the wrapper: kernel on CUDA tensors, plain
version on CPU tensors) and `ref.py` (the plain PyTorch version)."""
