"""The VQ-VAE's decoder in plain float32 PyTorch: codebook rows, a 3³
convolution to C channels, then per level the slim residual layers
(relu(x + conv1³(relu(conv3³(x))))) and a transposed convolution, ReLU
between levels and none after the last.  Parameters by the program's
``state_dict`` names from the benchmark's dict; nothing of the program
is imported.  ``rnd`` rounds each convolution's operands."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _ident(x):
    return x


def decode(p: Dict[str, torch.Tensor], cfg: dict, indices: torch.Tensor,
           rnd: Callable = _ident) -> torch.Tensor:
    """indices (B, d, h, w) → volumes (B, 1, D, H, W) float32."""
    x = p["vq.codebook"][indices.long()].permute(0, 4, 1, 2, 3)

    def conv(t, name, padding):
        return F.conv3d(rnd(t), rnd(p[name + ".weight"]), p[name + ".bias"], padding=padding)

    x = conv(x, "decoder_in_conv", 1)
    n = cfg["no_levels"]
    for i in range(n):
        for j in range(cfg["no_res_layers"]):
            pre = f"decoder_res.{i}.{j}"
            h = torch.relu(conv(x, pre + ".conv1", 1))
            x = torch.relu(x + conv(h, pre + ".conv2", 0))
        k, s, pad, op, dil = cfg["upsample_parameters"][i]
        x = F.conv_transpose3d(rnd(x), rnd(p[f"decoder_ups.{i}.weight"]),
                               p[f"decoder_ups.{i}.bias"], stride=s, padding=pad,
                               output_padding=op, dilation=dil)
        if i != n - 1:
            x = torch.relu(x)
    return x
