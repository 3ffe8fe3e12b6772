"""The Mamba2 SSD intra-chunk step: one CUDA launch per chunked scan (port of
`repro.kernels.ssd_scan`)."""
