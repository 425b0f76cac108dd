"""BENCHMARK.json against the rules of its format: keys, names, units,
bounds, and the files every entry names."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))


def test_workloads():
    pairs = set()
    four = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
        spec = json.loads((REPO / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        assert spec["config"] == w["config"]
        assert (REPO / "benchmark" / "drivers" / f"{spec['driver']}.py").is_file()
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_end_to_end_metrics():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if "workloads" not in m or w["name"] in m["workloads"]]
        layer = [m for m in SPEC["per_layer"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_per_layer_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", []):
            assert "workloads" not in moved or cell in moved["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_paths_hold_only_the_benchmark():
    for p in SPEC["paths"]:
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
