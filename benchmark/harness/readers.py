"""What the per-layer readers share: the idle share of the traced
window, and a kernel's share of its roofline from its launches and the
counts from shapes."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from benchmark.counts.peaks import BF16_FLOPS, F32_FLOPS, bound_s


def operands(cfg: dict, key: str = "compute_dtype"):
    """(bytes an element, peak operations a second) of the precision
    ``cfg[key]`` names: bf16 at the bf16 peak, float32 (TF32 off) at the
    float32 peak."""
    return (2, BF16_FLOPS) if cfg[key] == "bfloat16" else (4, F32_FLOPS)


def idle_pct(run) -> Optional[float]:
    """100 × the share of the traced window with no device operation."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(run, kernels: Iterable[str], calls: Iterable[tuple],
                 peak: float = BF16_FLOPS) -> Optional[float]:
    """100 × Σ the least time of each call ÷ Σ the device time of
    ``kernels``.  ``calls``: (launch names that count one call each,
    (flops, bytes) of one such call); operations at ``peak``."""
    tr = run.trace
    if tr is None:
        return None
    seconds = tr.device_seconds(kernels)
    least = 0.0
    for names, (flops, nbytes) in calls:
        least += sum(tr.count(n) for n in names) * bound_s(flops, nbytes, peak)
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds


def share_of_window(run, least_s: Callable[[int], float]) -> Optional[float]:
    """100 × the least time of the traced units' work ÷ the traced
    window; ``least_s(units)`` gives the former."""
    tr = run.trace
    units = int(run.facts.get("traced_units", 0))
    if tr is None or units == 0 or tr.window_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * least_s(units) / tr.window_s
