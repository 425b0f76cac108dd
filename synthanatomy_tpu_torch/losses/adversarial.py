"""Adversarial (GAN) criteria.

Port of ``synthanatomy_tpu/losses/adversarial.py``:

- ``vanilla``:      relu(1 ± logits)   (hinge form)
- ``hinge``:        softplus(± logits)
- ``least_square``: (logits − target)²

The discriminator averages its fake and real halves with 0.5; the
summaries use the reference's scalar names.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ADVERSARIAL_CRITERIA", "discriminator_loss", "generator_loss", "get_criterion"]

ADVERSARIAL_CRITERIA = ("vanilla", "hinge", "least_square")


def get_criterion(name: str) -> Callable[[torch.Tensor, bool], torch.Tensor]:
    if name == "vanilla":
        return lambda logits, is_real: torch.relu(1.0 + (-1.0 if is_real else 1.0) * logits)
    if name == "hinge":
        return lambda logits, is_real: F.softplus((-1.0 if is_real else 1.0) * logits)
    if name == "least_square":
        return lambda logits, is_real: torch.square(logits - (1.0 if is_real else 0.0))
    raise ValueError(f"Unknown adversarial criterion {name!r}; choices are "
                     f"{ADVERSARIAL_CRITERIA}.")


def generator_loss(logits_fake: torch.Tensor, *, criterion: str = "least_square",
                   weight: float = 0.005) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Generator side: fake logits scored as real."""
    loss_fake = torch.mean(get_criterion(criterion)(logits_fake.float(), True))
    return weight * loss_fake, {"Loss-Adversarial_Generator-Reconstruction": loss_fake}


def discriminator_loss(logits_fake: torch.Tensor, logits_real: torch.Tensor, *,
                       criterion: str = "least_square",
                       weight: float = 0.005) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Discriminator side: 0.5·(fake-as-fake + real-as-real)."""
    fn = get_criterion(criterion)
    loss_fake = torch.mean(fn(logits_fake.float(), False))
    loss_real = torch.mean(fn(logits_real.float(), True))
    return weight * 0.5 * (loss_fake + loss_real), {
        "Loss-Adversarial_Discriminator-Reconstruction": loss_fake,
        "Loss-Adversarial_Discriminator-Originals": loss_real,
    }
