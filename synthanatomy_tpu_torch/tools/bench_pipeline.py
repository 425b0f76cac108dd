"""End-to-end synthesis benchmark: paper-form sampling, then decode.

Port of ``tools/bench_pipeline.py``, with its flags (``--batch``,
``--reps``, ``--split``, parsed by the port's copy of ``parse_argv``)
and printed lines.  The paper-form Performer prior (24L/d512/16h, 8
local heads of window 420, ReZero, learned spatial tables; seeded random
weights) samples 1400-token latent grids, which the paper 4-level
256-channel VQ-VAE decodes to 160×224×160 volumes, all on the card
through ``pipeline.make_synthesizer`` (int8 weights, int8 rings).  Times
are host clocks around calls ended by ``torch.cuda.synchronize()``; the
first call ("compile+run", as the JAX tool names it) includes building
the kernels where they are not built yet.  ``--split`` times the sampler
alone and the decode alone.  ``--cpu`` runs the plain versions on the
host (at the module constants' sizes).

    python -m synthanatomy_tpu_torch.tools.bench_pipeline [--batch=16 --reps=3 --split]

``main`` returns the measured seconds and rates as a dict.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from synthanatomy_tpu_torch.cli import parse_argv
from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.models.performer import Performer
from synthanatomy_tpu_torch.models.sampling import make_sampler
from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
from synthanatomy_tpu_torch.pipeline import make_synthesizer
from synthanatomy_tpu_torch.tools._probe_util import device_name, probe_device

GRID = (10, 14, 10)
PRIOR = dict(dim=512, depth=24, heads=16, dim_head=64, local_attn_heads=8,
             local_window_size=420)
VQVAE = dict(n_levels=4, downsample_parameters=((4, 2, 1, 1),) * 4,
             upsample_parameters=((4, 2, 1, 0, 1),) * 4, n_embed=2048, embed_dim=32,
             n_channels=256, n_res_channels=256, n_res_layers=3)
DECODE_BATCH = 8


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    _, kw = parse_argv(sys.argv[1:] if argv is None else argv)
    batch = int(kw.get("batch", 16))
    reps = int(kw.get("reps", 3))
    dev = probe_device(bool(kw.get("cpu", False)))
    print(f"device: {device_name(dev)}")

    seq = int(np.prod(GRID))
    ordering = Ordering("raster_scan", 3, GRID)
    performer = Performer(
        num_tokens=VQVAE["n_embed"] + 1, max_seq_len=seq + 1, use_rezero=True,
        spatial_position_emb="absolute", spatial_shape=GRID, ordering=ordering,
        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0), device="cpu",
        **PRIOR).to(dev)
    vqvae = BaselineVQVAE(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(2),
                          device=dev, **VQVAE)
    synth = make_synthesizer(performer, vqvae, ordering, batch=batch, temperature=1.0,
                             decode_batch=DECODE_BATCH, ring_quant=True)
    gen = torch.Generator(device=dev)

    t0 = time.perf_counter()
    vols, grids = synth(gen.manual_seed(3))
    _sync(dev)
    print(f"[e2e] compile+run {time.perf_counter() - t0:.1f}s "
          f"volumes {tuple(vols.shape)} grids {tuple(grids.shape)}")
    if not bool(torch.isfinite(vols).all()):
        raise RuntimeError("bench_pipeline: non-finite volumes")

    t0 = time.perf_counter()
    for i in range(reps):
        vols, _ = synth(gen.manual_seed(4 + i))
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    print(f"[e2e] paper-form synthesis batch={batch}: {dt:.2f} s/batch → "
          f"{batch * 60 / dt:.1f} volumes/min/chip "
          f"({batch * seq / dt:.0f} latent tok/s incl. decode)")
    out = {"e2e_s": dt, "volumes_per_min": batch * 60 / dt, "tok_s": batch * seq / dt}

    if kw.get("split"):
        # stage decomposition: sampler alone, then decode alone
        sampler = make_sampler(performer, ordering, batch=batch, temperature=1.0,
                               fused="auto", ring_quant=True)
        grids = sampler(gen.manual_seed(3))
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(reps):
            grids = sampler(gen.manual_seed(4 + i))
        _sync(dev)
        sdt = (time.perf_counter() - t0) / reps
        print(f"[split] sampling alone: {sdt:.2f} s/batch "
              f"({batch * seq / sdt:.0f} tok/s)")
        with torch.no_grad():
            vqvae.decode_samples([grids[:DECODE_BATCH]])
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                for i in range(0, batch, DECODE_BATCH):
                    vqvae.decode_samples([grids[i: i + DECODE_BATCH]])
            _sync(dev)
        ddt = (time.perf_counter() - t0) / reps
        print(f"[split] decode alone ({batch} vols, sub-batch {DECODE_BATCH}): "
              f"{ddt:.2f} s/batch ({ddt / batch * 1e3:.0f} ms/vol)")
        out.update(sampling_s=sdt, decode_s=ddt)
    return out


if __name__ == "__main__":
    main()
