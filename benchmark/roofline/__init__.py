"""The least time a kernel's work could take on one H100, from its inputs.

A bound is the larger of the bytes bound (each input byte read once, each
output byte written once, at the HBM rate) and the operations bound (the
float32 operations the work needs, at the float32 peak). The counts are
taken from shapes and from the plain reference, never from a kernel's own
counters, so that they read the same work whatever implements it.
"""

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds: the larger of the bytes and the operations bound."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)
