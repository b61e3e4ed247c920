"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates without sparsity, at the card's full 700 W power limit).

A roofline share or an ``mfu`` is stated against these numbers; the run
prints the card's ``power.limit`` beside them, since a card set below 700 W
runs slower under load."""

# HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
# FP32 outside the tensor cores, FLOP per second
FP32_FLOPS_PER_S = 67e12
# the special-function unit (exp, log, rsqrt, sin, reciprocal): 16 operations
# per clock per SM (CUDA programming guide, compute capability 9.0) x 132 SMs
# x 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9


def least_seconds(flops: float, sfu: float, n_bytes: float) -> float:
    """The least time the card could take for a piece of work: the larger of
    its FP32 operations, its special-function operations and its bytes moved
    once, each at its peak rate."""
    return max(flops / FP32_FLOPS_PER_S, sfu / SFU_OPS_PER_S,
               n_bytes / HBM_BYTES_PER_S)
