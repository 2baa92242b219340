"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): the yardstick of every roofline share and
of the model FLOP utilization."""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time a call could take: the larger of its bytes over the
    memory rate and its operations over the fp32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
