"""Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, without sparsity)."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the card could take for this work: the larger of the
    operations at the peak rate and the bytes at the memory's rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
