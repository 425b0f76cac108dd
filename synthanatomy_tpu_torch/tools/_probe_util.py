"""What the probe tools share: the device choice and the timers."""

from __future__ import annotations

import subprocess
import time

import torch


SPIN_HZ = 2.0e9  # cycles a second of torch.cuda._sleep's spin (above the H100's SM clock)


def event_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` on the card: CUDA events around ``reps``
    back-to-back calls, after one warm-up call.  A call whose host side
    is slower than its kernels reads the host's pace."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: as :func:`event_ms`, but the calls are
    queued behind a GPU spin as long as 1.5x their host time, so a call
    whose host side (autograd, allocations, launches) is slower than its
    kernels times its kernels, not the host's gaps between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 2.0) * SPIN_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_us(fn, calls: int, reps: int) -> float:
    """µs per call of ``fn`` on the card, replayed from a CUDA graph of
    ``calls`` calls (no host work between its launches): CUDA events
    around ``reps`` replays, after one call outside the capture and one
    warm-up replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls) * 1e3


def probe_device(cpu: bool) -> torch.device:
    """The card, or the host with ``--cpu`` (the plain versions run
    there); no card and no ``--cpu`` raises."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible: pass --cpu for a sanity run on the host")
    return torch.device("cuda", 0)


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"


def elapsed_s(fn, dev: torch.device) -> float:
    """Seconds one call of ``fn`` takes: CUDA events on the card, the host
    clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-9)
