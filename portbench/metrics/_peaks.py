"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and bf16 operations over the tensor-core rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)
