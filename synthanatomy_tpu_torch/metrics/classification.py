"""Transformer CE metric (reference src/metrics/transformer.py:11-49)."""

from __future__ import annotations

import torch

from synthanatomy_tpu_torch.losses.transformer import ce_loss

__all__ = ["ce_metric"]


def ce_metric(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return ce_loss(logits, targets)[0]
