"""The NVIDIA H100 SXM's peaks, and the correlation kernel's bound from its
shapes: copies of ``islam_tpu_torch/tools/h100.py``'s datasheet rates and
of ``islam_tpu_torch/bench_corr.py::bound_ms``'s arithmetic.

Source: NVIDIA's H100 SXM5 datasheet, dense rates (no sparsity) at the
700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOAT32_FLOP_PER_S = 67e12
CORR_SHIFTS = 81


def roof_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(flops / FLOAT32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def corr_bound_seconds(shape, itemsize: int = 4) -> float:
    """One correlation call on (B, C, H, W) inputs: both inputs read once
    and the 81-channel output written once, against 2 x 81 x B C H W
    operations."""
    B, C, H, W = shape
    nbytes = (2 * B * C * H * W + B * CORR_SHIFTS * H * W) * itemsize
    return roof_seconds(2 * CORR_SHIFTS * B * C * H * W, nbytes)
