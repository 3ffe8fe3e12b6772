"""Frozen work formulas and the card's data-sheet peaks."""
# NVIDIA H100 SXM5 80GB data sheet at its 700 W limit: float32 on the
# CUDA cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32_FLOPS)
