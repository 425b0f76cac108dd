"""The harness: find a cell's files by name, run its driver, print the
result line.

A cell is ``BENCHMARK.json``'s ``workloads`` entry of that name.  Its
files (``benchmark/README.md``):

- ``benchmark/workloads/<cell>.json``: ``driver`` (a file
  ``benchmark/drivers/<driver>.py``), ``traffic`` (the driver's
  parameters) and ``trace`` (``{"first": i, "units": n}``: the units of
  work a ``--trace 1`` run profiles);
- ``benchmark/configs/<config>.json``: the configuration as it is run;
- ``benchmark/metrics/<metric>.py``: one per per-layer metric, with
  ``read(run) -> float | None``.

A driver module defines ``Driver(ctx)`` with ``setup()``, ``window(seconds,
tracer) -> Window``, ``release()`` and ``check() -> [Compared]``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

# top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "synthanatomy_tpu")


def forbidden_modules() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name is forbidden,
    compared whole (``synthanatomy_tpu_torch`` is not
    ``synthanatomy_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Compared:
    """One number of the output check beside its limit: the run is
    correct only where every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Window:
    """What a measured window did: the end-to-end metrics' values by name,
    units attempted and failed, and facts the per-layer readers use (the
    counts of work in the traced units, shapes)."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    facts: Dict[str, object] = field(default_factory=dict)


@dataclass
class Cell:
    name: str
    entry: dict  # the BENCHMARK.json workloads entry
    config: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def file(self, *parts) -> Path:
        return self.root.joinpath("benchmark", *parts)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name``: its ``BENCHMARK.json`` entry and the files it
    names."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = json.loads((root / "benchmark" / "workloads" / f"{name}.json").read_text())
    cfg_file = next(c["file"] for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_file).read_text())
    return Cell(name, entry, config, workload,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], root)


def load_module(path: Path, name: str):
    """Import the file at ``path`` (its name may hold dots) as ``name``."""
    mod_name = "bench_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a driver is given: the cell, the seed, the device and the
    spans object of the run."""

    cell: Cell
    seed: int
    device: object
    spans: object

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.workload["traffic"]


@dataclass
class TracedRun:
    """What a per-layer reader reads: the trace, the spans, the window's
    facts and the cell's configuration."""

    trace: object
    spans: Dict[str, List[float]]
    facts: Dict[str, object]
    config: dict


def parse_args(argv):
    p = argparse.ArgumentParser(description="One run of one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _device_kind(torch, device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def per_layer_values(cell: Cell, run: TracedRun) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for; a reader that returns None is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(cell.file("metrics", f"{m['name']}.py"), m["name"])
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv, *, root: Path, t0: float, allow_cpu: bool = False) -> int:
    """One run; returns the exit code.  ``allow_cpu`` (tests only) skips
    the look for a card and runs on the host."""
    args = parse_args(argv)
    cell = load_cell(root, args.workload)
    import torch

    from benchmark.harness.trace import Spans, Tracer

    if allow_cpu:
        device = torch.device("cpu")
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            print(f"benchmark: the cell {cell.name} needs {cell.chips} CUDA card(s), "
                  f"{n} visible", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    driver = load_module(cell.file("drivers", f"{cell.workload['driver']}.py"),
                         cell.workload["driver"])
    spans = Spans(device)
    ctx = Context(cell, args.seed, device, spans)
    drv = driver.Driver(ctx)

    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    tr = cell.workload.get("trace", {})
    tracer = Tracer(bool(args.trace), device, spans, first=int(tr.get("first", 1)),
                    count=int(tr.get("units", 1)))
    win = drv.window(args.seconds, tracer)
    tracer.close()
    win.facts["traced_units"] = tracer.units
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = drv.check()

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": _device_kind(torch, device), "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": win.failed == 0 and all(c.ok for c in compared),
              "attempted": int(win.attempted), "failed": int(win.failed)}
    if args.trace:
        trace = tracer.trace
        run = TracedRun(trace, dict(spans.seconds), win.facts, cell.config)
        result["metrics"] = per_layer_values(cell, run)
        if trace is not None:
            dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["device"] = dev
        if trace is not None:
            result["breakdown"] = {"device_ops": trace.top_device_ops(),
                                   "idle_gaps": trace.idle_gaps()}
    else:
        values = dict(win.metrics, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    for c in compared:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    # last, after the readers too: whatever they imported counts
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
