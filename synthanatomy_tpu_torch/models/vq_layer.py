"""Reusable dimension-generic EMA vector-quantization layer.

Port of ``synthanatomy_tpu/models/vq_layer.py``: the API of the
reference's second, unused VQ implementation (``VectorQuantizerEMA``,
src/layers/vector_quantization.py:9-198): quantization of channels-last
inputs of any spatial rank returning flat / one-hot / indices, an
``embed`` op and a ``kaiming_uniform`` init option, over the port's
``ops/vq.py`` (the nearest-codeword kernel on the card, its plain
version on the CPU).  The EMA state is the submodule ``ema`` (buffers
``ema.codebook``, ``ema.cluster_size``, ``ema.embed_avg``), JAX's
``{"vq": {"ema": VQState}}``; ``interop.vq_layer_from_jax`` carries it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from synthanatomy_tpu_torch.ops import vq as vq_ops

__all__ = ["VectorQuantizerEMA"]


class VectorQuantizerEMA(nn.Module):
    """Channels-last EMA VQ for any spatial rank (inputs ``(B, *spatial,
    D)``).  ``use_pallas`` is JAX's switch: None takes the kernel on the
    card and the plain search on the CPU, False the plain search
    everywhere."""

    def __init__(self, num_embeddings: int, embedding_dim: int, commitment_cost: float = 0.25,
                 decay: float = 0.99, epsilon: float = 1e-5, embedding_init: str = "normal",
                 use_pallas: Optional[bool] = None, *, device="cuda",
                 generator: torch.Generator = None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.commitment_cost, self.decay, self.epsilon = commitment_cost, decay, epsilon
        self.use_pallas = use_pallas
        self.ema = vq_ops.init_vq_state(num_embeddings, embedding_dim, embedding_init,
                                        generator=generator, device=device)

    def forward(self, x: torch.Tensor, *, training: bool = False, process_group=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (quantized_st, commitment_loss); with ``training`` the
        EMA state is updated in place, from the statistics of every rank
        of ``process_group`` when one is given (JAX's ``axis_name``)."""
        q, loss, _, _ = vq_ops.quantize_ema(
            self.ema, x, decay=self.decay, commitment_cost=self.commitment_cost,
            training=training, eps=self.epsilon, plain=self.use_pallas is False,
            process_group=process_group)
        return q, loss

    def quantize(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, *s, D) → (flat_quantized (N, D), one_hot (N, K), indices
        (B, *s)): the reference layer's ``quantize`` contract
        (vector_quantization.py:135-178)."""
        flat = x.float().reshape(-1, self.embedding_dim)
        search = vq_ops.nearest_codeword_plain if self.use_pallas is False \
            else vq_ops.nearest_codeword
        idx = search(flat, self.ema.codebook)
        one_hot = nn.functional.one_hot(idx.long(), self.num_embeddings).float()
        flat_q = vq_ops.embed_indices(self.ema, idx)
        return flat_q, one_hot, idx.reshape(x.shape[:-1])

    def embed(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (B, *s) → codewords (B, *s, D)."""
        return vq_ops.embed_indices(self.ema, indices)

    @property
    def perplexity_fn(self):
        return lambda idx: vq_ops.perplexity(idx, self.num_embeddings)
