"""The traced part of a window: torch.profiler over a run of whole units
of work, reduced to device intervals, host events and the benchmark's
own spans.

Only ``--trace 1`` runs trace.  The harness hands the driver a
:class:`Tracer`; the driver wraps each unit of work (a synthesis call, a
train step) in ``tracer.unit(i)``, and units ``first .. first + count -
1`` run under the profiler, the device synchronised at both ends, inside
one ``bench.window`` annotation whose bounds are the traced window.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_MARK = "bench.window"
# what the device does: kernels, copies and fills
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}


def kernel_base_name(name: str) -> str:
    """``void (anonymous namespace)::foo_kernel<T, 64>(Args)`` →
    ``foo_kernel``."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    s = s.split("(")[0].split("<")[0]
    return s.split("::")[-1].strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class Trace:
    """Device operations ``(name, start_ns, end_ns)`` and host events
    inside the traced window ``(t0_ns, t1_ns)``."""

    window: Tuple[int, int]
    device_ops: List[Tuple[str, int, int]]
    host_events: List[Tuple[str, int, int]]

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        window = None
        device_ops, host = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if kind in _DEVICE_KINDS or (not kind and not e.is_user_annotation()):
                    device_ops.append((name, start, end))
            elif name == WINDOW_MARK:
                window = (start, end)
            else:
                host.append((name, start, end))
        if window is None:
            raise RuntimeError("the traced window's annotation is missing from the trace")
        t0, t1 = window
        device_ops = [(n, max(s, t0), min(e, t1)) for n, s, e in device_ops if e > t0 and s < t1]
        host = [(n, s, e) for n, s, e in host if e > t0 and s < t1]
        return cls(window, device_ops, host)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        return _merge([(s, e) for _, s, e in self.device_ops if e > s])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernels(self, names) -> List[Tuple[str, int, int]]:
        """Device operations whose base name is in ``names``."""
        names = set(names)
        return [op for op in self.device_ops if kernel_base_name(op[0]) in names]

    def count(self, name: str) -> int:
        return sum(1 for op in self.device_ops if kernel_base_name(op[0]) == name)

    def device_seconds(self, names) -> float:
        """Seconds in which one of ``names`` ran: the union of their
        intervals, since a launch that overlaps its predecessor (a
        programmatic dependent launch) waits inside its own interval."""
        return sum(e - s for s, e in _merge([(s, e) for _, s, e in self.kernels(names)])) * 1e-9

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, int] = defaultdict(int)
        for name, s, e in self.device_ops:
            tot[name[:160]] += e - s
        return [[k, v * 1e-9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, short_ns: int = 5000) -> List[list]:
        """Idle time on the device summed by what the host was doing when
        each gap began (the innermost host event open then); gaps under
        ``short_ns`` are summed as one entry."""
        t0, t1 = self.window
        gaps, cur = [], t0
        for s, e in self.busy_intervals():
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if t1 > cur:
            gaps.append((cur, t1))
        events = sorted(self.host_events, key=lambda x: x[1])
        starts = [s for _, s, _ in events]
        tot: Dict[str, int] = defaultdict(int)
        heap: list = []
        i = 0
        for g0, g1 in gaps:
            if g1 - g0 < short_ns:
                tot[f"gaps under {short_ns // 1000} us"] += g1 - g0
                continue
            j = bisect.bisect_right(starts, g0)
            while i < j:
                heapq.heappush(heap, (-events[i][1], events[i][2], events[i][0]))
                i += 1
            while heap and heap[0][1] < g0:
                heapq.heappop(heap)
            tot[f"host in {heap[0][2]}" if heap else "host between events"] += g1 - g0
        return [[k, v * 1e-9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


@dataclass
class Spans:
    """The benchmark's own spans around calls into the program, recorded
    only while the traced window is open: each call synchronises the
    device before and after, so a span is the call's whole time."""

    device: torch.device
    active: bool = False
    seconds: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))

    def wrap(self, name: str, fn):
        def spanned(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            _sync(self.device)
            t = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
                _sync(self.device)
            self.seconds[name].append(time.perf_counter() - t)
            return out

        return spanned


class Tracer:
    """Profiles units ``first .. first + count - 1`` of the window when
    enabled; a no-op otherwise."""

    def __init__(self, enabled: bool, device: torch.device, spans: Spans, *, first: int = 1,
                 count: int = 1):
        self.enabled, self.device, self.spans = enabled, device, spans
        self.first, self.count = first, count
        self.trace: Optional[Trace] = None
        self.units = 0  # units traced
        self._prof = self._mark = None

    @contextlib.contextmanager
    def unit(self, i: int):
        if self.enabled and i == self.first and self._prof is None and self.trace is None:
            self._start()
        try:
            yield
        finally:
            if self._prof is not None:
                self.units += 1
                if i >= self.first + self.count - 1:
                    self.close()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync(self.device)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False, with_stack=False)
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()
        self.spans.active = True

    def close(self) -> None:
        """End the traced window if it is open (the window may end before
        the last traced unit)."""
        if self._prof is None:
            return
        _sync(self.device)
        self.spans.active = False
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        self.trace = Trace.from_profile(self._prof)
        self._prof = self._mark = None
