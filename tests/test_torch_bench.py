"""The port's headline entry point (``synthanatomy_tpu_torch/tools/
bench.py``, the top-level ``bench.py``'s counterpart) at a tiny prior on
the CPU: one JSON line with bench.py's keys, the fused sampler taken (no
fallback), finite positive numbers."""

import json
import os

import pytest
import torch

from synthanatomy_tpu_torch.models import sampling
from synthanatomy_tpu_torch.tools import bench

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TINY = ["--cpu"]


def test_bench_prints_one_json_line(capsys):
    out = bench.main(TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == out
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == "ar_sampling_tokens_per_sec_paper24L"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert "cpu" in line["unit"] and "chip" not in line["unit"]
    assert "1L/d128" in line["unit"]  # the sanity form, named


def test_the_card_measures_only_the_paper_form():
    """The entry point's only flag is ``--cpu``: no width can be set."""
    assert bench.PAPER == dict(batch=16, depth=24, dim=512, heads=16, local_heads=8,
                               window=420, grid=(10, 14, 10), vocab=2048, reps=3,
                               naive_warmup=4, naive_steps=60)
    for flag in (["--depth", "1"], ["--batch", "2"], ["--grid", "2,3,4"]):
        with pytest.raises(SystemExit):
            bench.parse_args(flag)


def test_bench_has_no_fallback(monkeypatch):
    """A prior the fused step does not take ends the run."""
    real = sampling.make_sampler

    def exact_only(*a, **k):
        s = real(*a, **dict(k, fused=False))
        return s

    monkeypatch.setattr(sampling, "make_sampler", exact_only)
    with pytest.raises(RuntimeError, match="fused decode step"):
        bench.main(TINY)


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        bench.main([])
