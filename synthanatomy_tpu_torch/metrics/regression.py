"""Voxelwise regression metrics (reference src/metrics/vqvae.py)."""

from __future__ import annotations

import torch

__all__ = ["mae", "mse"]


def mae(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(y_pred.float() - y.float()))


def mse(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(y_pred.float() - y.float()))
