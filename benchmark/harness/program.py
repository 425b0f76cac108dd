"""The program under test, built as its CLIs build it, with the
benchmark's weights.

Everything here calls into ``synthanatomy_tpu_torch`` (the port): its
configuration classes, the runners' model builders, and nothing else.
Each model is built on the device (its own initialisation drawn there
and thrown away), then every floating tensor is replaced by the
benchmark's draw (``weights.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import torch

from benchmark.harness import weights as W


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one use (``tag``) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config_of(cls, cfg: dict):
    """``cls`` (a CLI configuration dataclass) from the keys of ``cfg``
    it has; lists become tuples, as the CLI parses them."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _tuples(v) for k, v in cfg.items() if k in names})


def load_config(root: Path, name: str) -> dict:
    """Another configuration of the benchmark, by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entries = [c for c in spec["configs"] if c["name"] == name]
    path = (root / entries[0]["file"]) if entries else (
        root / "benchmark" / "configs" / f"{name}.json")
    return json.loads(path.read_text())


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def build_prior(cfg: dict, seed: int, device):
    """(model, ordering, weight shapes): the stage-2 CLI's prior of
    ``cfg`` with the draw of ``seed``."""
    from synthanatomy_tpu_torch.config import TransformerConfig
    from synthanatomy_tpu_torch.runners.transformer import build_ordering, build_performer

    tc = config_of(TransformerConfig, cfg)
    grid = tuple(cfg["latent_shape"])
    ordering = build_ordering(tc, grid)
    with torch.device(device):
        model = build_performer(tc, ordering, grid, device=device,
                                generator=_generator(device))
    shapes = W.shapes_of(model)
    W.load(model, W.draw(shapes, seed, device))
    return model, ordering, shapes


def build_vqvae(cfg: dict, seed: int, device):
    """(model, weight shapes): the stage-1 CLI's VQ-VAE of ``cfg`` with
    the draw of ``seed``."""
    from synthanatomy_tpu_torch.config import VQVAEConfig
    from synthanatomy_tpu_torch.runners.vqvae import build_vqvae as build

    vc = config_of(VQVAEConfig, cfg)
    with torch.device(device):
        model = build(vc, device=device, generator=_generator(device))
    shapes = W.shapes_of(model)
    W.load(model, W.draw(shapes, seed, device))
    return model, shapes


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
