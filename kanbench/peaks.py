"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit): what every roofline and ``mfu`` share is
taken against. A run prints the card's power limit beside them."""

#: FLOP/s, bf16 on the tensor cores, dense: the fastest rate of the card
#: whose products can hold the f32 SH-LUT taps exactly (as a split into
#: bf16 parts), so no kernel of these layers can compute faster
FLOPS = 989e12

#: bytes/s of HBM3
HBM_BYTES = 3.35e12


def bound_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take for the work: the larger of the
    operations over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / FLOPS, n_bytes / HBM_BYTES)
