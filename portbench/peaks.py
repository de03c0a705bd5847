"""Peak rates of the card, from NVIDIA's data sheet of the H100 SXM (dense
rates, no sparsity, at the full 700 W power limit; the result line carries
the card's own name and power limit beside them)."""

HBM_BYTES_PER_S = 3.35e12       # HBM3
F32_FLOPS_PER_S = 67e12         # float32 on the CUDA cores


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time the card could take: the bytes over the memory
    bandwidth or the float32 operations over the float32 rate, whichever
    is larger, in milliseconds."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
