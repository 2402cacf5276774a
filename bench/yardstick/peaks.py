"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit). Shares of a roofline or
of a peak are taken against these, with the card's power limit reported
beside them."""
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80e9


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the memory bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
