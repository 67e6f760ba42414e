"""Published peaks of the card and the work of the kernels whose roofline
share the benchmark reports.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full power limit
of 700 W; the result line carries the card's own limit beside them.
"""

from __future__ import annotations

#: float32 outside the tensor cores, FLOP/s
PEAK_F32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s
PEAK_HBM_BYTES = 3.35e12


def gj_inverse_flops(b: int, n: int) -> float:
    """Gauss-Jordan inversion of ``b`` f32 matrices of order ``n``: 2 n^3
    each (one multiply and one add per entry of the n x n update, n
    times)."""
    return 2.0 * b * n ** 3


def gj_inverse_bytes(b: int, n: int) -> float:
    """Each f32 matrix read once and its inverse written once."""
    return 8.0 * b * n ** 2


def gj_inverse_min_seconds(b: int, n: int) -> float:
    """The least time the card could take for one call: the larger of
    its flops over the f32 peak and its bytes over the bandwidth."""
    return max(gj_inverse_flops(b, n) / PEAK_F32_FLOPS,
               gj_inverse_bytes(b, n) / PEAK_HBM_BYTES)
