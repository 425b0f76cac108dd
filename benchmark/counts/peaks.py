"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time a piece of work
can take on it."""

from __future__ import annotations

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The larger of the time the operations need at ``peak`` and the
    time the bytes need at the memory's rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)
