"""Two-stage synthesis: AR sampling of latent grids, then VQ-VAE decode.

Port of ``synthanatomy_tpu/pipeline.py`` (``make_synthesizer``).  The
sampled grids stay on the device between the stages; decoding runs in
sub-batches of ``decode_batch`` volumes.
"""

from __future__ import annotations

from typing import Optional

import torch

from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.models.sampling import make_sampler

__all__ = ["make_synthesizer"]


def make_synthesizer(
    performer,
    vqvae,
    ordering: Ordering,
    *,
    batch: int = 1,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    do_sample: bool = True,
    with_conditionings: bool = False,
    decode_batch: int = 8,
    ring_quant: bool = True,
):
    """Return ``synthesize(generator=None, conditionings=None) ->
    (volumes (B, 1, D, H, W), grids (B, *dims))``."""
    sampler = make_sampler(
        performer, ordering, batch=batch, temperature=temperature,
        top_k=top_k, do_sample=do_sample,
        with_conditionings=with_conditionings, ring_quant=ring_quant,
    )
    db = min(decode_batch, batch)
    while batch % db != 0:
        db -= 1

    @torch.no_grad()
    def synthesize(generator=None, conditionings=None):
        grids = sampler(generator, conditionings)
        vols = [
            vqvae.decode_samples([grids[i: i + db]]) for i in range(0, batch, db)
        ]
        volumes = torch.cat(vols, dim=0) if len(vols) > 1 else vols[0]
        return volumes, grids

    return synthesize
