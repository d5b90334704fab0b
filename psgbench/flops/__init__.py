"""Operation and byte counts from shapes, and the card's published peaks."""

# one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline's least time: the larger of the operations at the bf16
    peak and the bytes at the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
