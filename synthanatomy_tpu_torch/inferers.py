"""Forward-pass strategies ("inferers").

Port of ``synthanatomy_tpu/inferers.py``: callables that decide *which*
forward pass to run (SURVEY.md §2.8).  Where JAX's take the flax
variables, these hold the modules (which hold their weights) and run
under ``torch.no_grad``:

- ``VQVAEExtractionInferer``  (src/inferer/vqvae.py:9-45):
  index_quantize → decode_samples, returning the reconstruction plus
  the ``quantization_i`` codebook indices;
- ``VQVAEDecodingInferer``    (src/inferer/vqvae.py:48-87):
  decode_samples on loaded latent index grids;
- ``TransformerTrainingInferer`` (src/inferer/transformer.py:10-29):
  next-token logits for the CE loss, kept (B, L, V);
- ``TransformerInferenceInferer`` (src/inferer/transformer.py:32-71):
  KV-cached sampling with temperature / top-k / multinomial, on the
  port's ``make_sampler``.

Volumes are NCDHW (the port's layout); with a discriminator, its
logits on the f32 reconstruction come back as ``adversarial_logits``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

__all__ = [
    "VQVAEExtractionInferer",
    "VQVAEDecodingInferer",
    "TransformerTrainingInferer",
    "TransformerInferenceInferer",
]


def _with_adversarial(out: Dict[str, Any], recon: torch.Tensor, d_model) -> Dict[str, Any]:
    if d_model is not None:
        out["adversarial_logits"] = d_model(recon.float(), training=False)
    return out


class VQVAEExtractionInferer:
    def __init__(self, model, d_model=None):
        self.model = model
        self.d_model = d_model

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> Dict[str, Any]:
        idx = self.model.index_quantize(images)
        recon = self.model.decode_samples(idx)
        out = {"reconstruction": [recon]}
        for i, q in enumerate(idx):
            out[f"quantization_{i}"] = q
        return _with_adversarial(out, recon, self.d_model)


class VQVAEDecodingInferer:
    def __init__(self, model, d_model=None):
        self.model = model
        self.d_model = d_model

    @torch.no_grad()
    def __call__(self, quantizations: Sequence[torch.Tensor]) -> Dict[str, Any]:
        recon = self.model.decode_samples(list(quantizations))
        return _with_adversarial({"sample": [recon]}, recon, self.d_model)


class TransformerTrainingInferer:
    def __init__(self, model):
        self.model = model

    def __call__(self, inputs: torch.Tensor, conditionings=None) -> torch.Tensor:
        return self.model(inputs, conditionings)


class TransformerInferenceInferer:
    def __init__(
        self,
        model,
        ordering,
        *,
        batch: int,
        sample: bool = True,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        with_conditionings: bool = False,
        ring_quant: bool = False,
        fused="auto",
    ):
        from synthanatomy_tpu_torch.models.sampling import make_sampler

        self._sampler = make_sampler(
            model, ordering, batch=batch, do_sample=sample,
            temperature=temperature, top_k=top_k,
            with_conditionings=with_conditionings,
            ring_quant=ring_quant, fused=fused,
        )
        self.with_conditionings = with_conditionings

    def __call__(self, generator: Optional[torch.Generator] = None,
                 conditionings=None) -> torch.Tensor:
        if self.with_conditionings:
            return self._sampler(generator, conditionings)
        return self._sampler(generator)
