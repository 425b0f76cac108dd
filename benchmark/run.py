"""One run of one cell of the synthanatomy_tpu_torch benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files
are found by name (``benchmark/README.md``).  The run builds the cell's
program from the seed, warms up, measures for ``--seconds``, checks what
the timed path produced against the plain reference in
``benchmark/reference/`` and prints one JSON line as the last line of
its standard output.  ``--trace 1`` traces part of the window with
``torch.profiler`` and prints the cell's per-layer metrics instead of its
end-to-end ones.  Without enough CUDA cards it exits with code 2 and
prints no result.
"""

from __future__ import annotations

import time

_PROCESS_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    before torch is imported."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


if __name__ == "__main__":
    _cache_dirs(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness.core import main

    sys.exit(main(sys.argv[1:], root=ROOT, t0=_PROCESS_T0))
