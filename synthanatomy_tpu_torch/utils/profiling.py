"""Profiling / device observability.

Port of ``synthanatomy_tpu/utils/profiling.py`` on ``torch.profiler``
and ``torch.cuda.memory_stats``: the Ignite ``GpuInfo`` progress-bar
metric becomes :func:`device_memory_summary`, and the
``training_epoch_length`` short-profiling-epoch idiom is complemented by
a real trace: set ``SYNTHANATOMY_PROFILE_DIR=/path`` (or pass
``profile_dir``) and the first ``SYNTHANATOMY_PROFILE_STEPS`` (default
5) train steps of a run are traced (host and CUDA activity), each step
inside a ``train#<step>`` annotation, and written as a Chrome trace,
``<dir>/trace.json``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch

__all__ = ["StepProfiler", "device_memory_summary"]


def device_memory_summary(device=None) -> Dict[str, float]:
    """Bytes-in-use / peak / limit of the CUDA device (MB); {} for the
    CPU or without a card."""
    if not torch.cuda.is_available() or torch.device(device or "cuda").type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    mb = 1.0 / (1024 * 1024)
    out = {}
    for src, dst in (
        ("allocated_bytes.all.current", "Device-Memory-InUse-MB"),
        ("allocated_bytes.all.peak", "Device-Memory-Peak-MB"),
    ):
        if src in stats:
            out[dst] = stats[src] * mb
    out["Device-Memory-Limit-MB"] = torch.cuda.get_device_properties(device).total_memory * mb
    return out


class StepProfiler:
    """Trace the first N steps of a run when enabled.

    >>> prof = StepProfiler(profile_dir)   # None → env var → disabled
    >>> for step in ...:
    ...     with prof.step(step):
    ...         train_step(...)
    >>> prof.close()                       # writes <profile_dir>/trace.json

    In a data-parallel job only ``rank`` 0 traces (one trace.json).
    """

    def __init__(self, profile_dir: Optional[str] = None, num_steps: Optional[int] = None,
                 *, rank: int = 0):
        self.dir = None if rank else profile_dir or os.environ.get("SYNTHANATOMY_PROFILE_DIR")
        self.num_steps = num_steps or int(
            os.environ.get("SYNTHANATOMY_PROFILE_STEPS", "5")
        )
        self._prof = None
        self._seen = 0

    def _stop(self):
        if self._prof is not None:
            self._prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
            self._prof = None
        self.dir = None

    def step(self, step_num: int):
        if self.dir is None:
            return contextlib.nullcontext()
        if self._seen == self.num_steps:
            self._stop()
            return contextlib.nullcontext()
        if self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        self._seen += 1
        return torch.profiler.record_function(f"train#{step_num}")

    def close(self):
        self._stop()
