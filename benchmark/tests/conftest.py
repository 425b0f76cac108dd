"""Fixtures of the benchmark's own tests.

    python -m pytest -q benchmark/tests            # here, on the CPU
    python -m pytest -q -m gpu benchmark/tests     # on a card: the control readings

The repository's ``pytest tests/`` does not collect these.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs an NVIDIA card and the CUDA toolkit; skips elsewhere")


@pytest.fixture
def bench_root(tmp_path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ in a temporary root."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


@pytest.fixture
def card():
    """The CUDA card, decided here and not at import; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
