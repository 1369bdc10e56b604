"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  Every share of a peak or of a
roofline in this benchmark is taken against these numbers; the card's
power limit is printed beside each run's result."""

#: bf16 and fp16 tensor-core rate, FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of its
    operations over the bf16 peak and its bytes over the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
