"""The card's published peaks and the least time a piece of work needs.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W): 3.35 TB/s of
HBM3 and 989 TFLOP/s of bf16 tensor-core work. A roofline share states the
least time against these, whatever power limit the card runs at; the result
line gives the limit beside it.
"""

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def least_seconds(nbytes: float, ops: float) -> float:
    """Bytes over the memory rate or operations over the bf16 peak,
    whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
