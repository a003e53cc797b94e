"""Published peaks of one NVIDIA H100 SXM and the operation and byte counts
of the port's kernels, for their roofline shares.

Copied from the port's kernel_times.k1_bound (the sync scan K1): y (C, T)
complex float32 read once, err and fr written once; per position the
17-tap complex filter (34 multiplies, 32 adds), the atan2 with its
division, the 16 unwrap-and-sum steps and the line fit.  The float32 peak
outside the tensor cores counts a fused multiply-add as two operations.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet, 700 W
FP32_FLOP_PER_S = 67e12          # float32, non-tensor, same sheet
K1_FLOPS = {"stream": 66 + 40 + 16 * 15 + 7, "fused": 66 + 30 + 283}


def k1_bound_s(c: int, t: int, mode: str) -> float:
    """Least time of one sync scan over (c, t): the larger of its bytes over
    the memory peak and its operations over the float32 peak."""
    nbytes = c * t * (8 + 4 + 4)
    flops = c * t * K1_FLOPS[mode]
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
