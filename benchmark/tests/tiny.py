"""Tiny cells for the benchmark's CPU tests: a copy of the benchmark in a
temporary root, tiny configurations and cells added as files."""

from __future__ import annotations

import json
import time
from pathlib import Path

# the paper forms at widths the CPU runs in seconds (the fused step's
# plain version needs 64-wide heads and a model width of a multiple of 128)
TINY_PRIOR = dict(vocab_size=31, n_embd=128, n_layers=1, n_head=2, dim_head=64,
                  local_attn_heads=1, local_window_size=6, nb_features=128,
                  latent_shape=[2, 3, 4], decoder="tiny-vqvae")
TINY_VQVAE = dict(no_levels=2, no_channels=8, no_res_layers=1, num_embeddings=[31],
                  embedding_dim=[4], downsample_parameters=[[4, 2, 1, 1]] * 2,
                  upsample_parameters=[[4, 2, 1, 0, 1]] * 2, volume_shape=[8, 12, 16],
                  batch_size=2)


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")


def add_tiny(root: Path, cell: str, *, name: str = None, traffic: dict = None) -> str:
    """Add, as new files and entries, a tiny configuration and a cell
    ``tiny-<cell>`` that runs ``cell``'s driver on it."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(w for w in spec["workloads"] if w["name"] == cell)
    base = json.loads((root / next(c["file"] for c in spec["configs"]
                                   if c["name"] == entry["config"])).read_text())
    cfg_name = f"tiny-{entry['config']}"
    if not (bench / "configs" / f"{cfg_name}.json").exists():
        _write(bench / "configs" / f"{cfg_name}.json", dict(base, name=cfg_name, **TINY_PRIOR))
        spec["configs"].append({"name": cfg_name, "source": "tests", "reduced": [],
                                "file": f"benchmark/configs/{cfg_name}.json", "why": "tests"})
    if not (bench / "configs" / "tiny-vqvae.json").exists():
        vq = json.loads((bench / "configs" / "sashimi-vqvae-paper.json").read_text())
        _write(bench / "configs" / "tiny-vqvae.json", dict(vq, name="tiny-vqvae", **TINY_VQVAE))
    wl = json.loads((bench / "workloads" / f"{cell}.json").read_text())
    name = name or f"tiny-{cell}"
    wl.update(name=name, config=cfg_name)
    wl["traffic"] = dict(wl["traffic"], batch=2, **(traffic or {}))
    wl["trace"] = {"first": 0, "units": 1}  # a window of one unit still traces
    _write(bench / "workloads" / f"{name}.json", wl)
    spec["workloads"].append(dict(entry, name=name, config=cfg_name))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and cell in m["workloads"]:
            m["workloads"].append(name)
    _write(root / "BENCHMARK.json", spec)
    return name


def run_cell(root: Path, cell: str, *, seed: int = 3000000001, seconds: float = 1.0,
             trace: int = 0, capsys=None) -> dict:
    """One CPU dry run of ``cell``; returns its result line."""
    from benchmark.harness.core import main

    rc = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(trace)], root=root, t0=time.perf_counter(), allow_cpu=True)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
