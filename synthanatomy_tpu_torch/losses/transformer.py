"""Stage-2 (autoregressive prior) loss: token cross-entropy.

Port of ``synthanatomy_tpu/losses/transformer.py::ce_loss``: logits stay
(B, L, V), are cast to f32 and log-softmaxed; an optional (B, L) mask
excludes positions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["ce_loss"]


def ce_loss(
    logits: torch.Tensor, targets: torch.Tensor, *, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy of (B, L, V) logits against (B, L) int targets."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(torch.float32)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss, {"Loss-CE": loss}
