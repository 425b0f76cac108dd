"""Weights made from the seed, on the device, in one draw.

The benchmark makes every floating tensor of a model's ``state_dict``
itself (names and shapes are the program's), from one standard-normal
draw of a generator on the device, and hands the same tensors to the
program (``load_state_dict``) and to the reference.  The same seed on the
same device gives the same tensors, so a check after the window draws
them again instead of keeping a copy beside the program.

Scales: a weight of fan-in f is N(0, 1/f) (a convolution's N(0, 2/f),
as ReLU stacks keep their scale); biases N(0, 0.02²); LayerNorm gains
1 + N(0, 0.1²) and shifts N(0, 0.1²); ReZero gains 0.1 + N(0, 0.02²),
so that every block's attention and feed-forward reach the output (a
zero gain would leave them out of the logits and of the gradients); a
FAVOR+ projection is the Performer's orthogonal random features (rows
of Q factors of Gaussian blocks, scaled by chi-distributed norms); the
EMA codebook N(0, 1), its running sum equal to it and its counts zero,
as a fresh codebook has them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]


def shapes_of(module: torch.nn.Module) -> Shapes:
    """The floating tensors of ``module.state_dict()``: (name, shape)."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()
            if v.is_floating_point()]


def _orthogonal_features(z_blocks: torch.Tensor, z_norms: torch.Tensor) -> torch.Tensor:
    """(n, m, d) projections from (n, m // d, d, d) and (n, m, d) normals."""
    q, _ = torch.linalg.qr(z_blocks)
    n, nb, d, _ = z_blocks.shape
    mat = q.transpose(-1, -2).reshape(n, nb * d, d)
    return torch.linalg.vector_norm(z_norms, dim=-1, keepdim=True) * mat


def _scaled(name: str, z: torch.Tensor) -> torch.Tensor:
    last = name.rsplit(".", 1)[-1]
    if last in ("g_attn", "g_ff"):
        return 0.1 + 0.02 * z
    if name.startswith("vq."):
        return torch.zeros_like(z) if last == "cluster_size" else z
    if last == "bias":
        if "norm" in name:
            return 0.1 * z
        return 0.02 * z
    if z.dim() == 1:  # a LayerNorm gain
        return 1.0 + 0.1 * z
    if z.dim() == 2:  # linear (out, in) and embedding (rows, dim) tables
        return z / math.sqrt(z.shape[1])
    # convolutions: (out, in, k, k, k); transposed (in, out, k, k, k), a
    # stride-2 kernel of 4 reaching each output from 2³ taps a channel
    k3 = z[0, 0].numel()
    if name.startswith("decoder_ups."):
        return z * math.sqrt(2.0 / (z.shape[0] * max(1, k3 // 8)))
    return z * math.sqrt(2.0 / (z.shape[1] * k3))


def draw(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 tensors for ``shapes`` (see the module docstring)."""
    device = torch.device(device)
    proj = [(k, s) for k, s in shapes if k.endswith(".projection")]
    plain = [(k, s) for k, s in shapes if not k.endswith(".projection")]
    n_plain = sum(math.prod(s) for _, s in plain)
    n_proj = sum(2 * math.prod(s) for _, s in proj)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(n_plain + n_proj, generator=gen, device=device)
    out, off = {}, 0
    for k, s in plain:
        n = math.prod(s)
        out[k] = _scaled(k, flat[off:off + n].view(s)).contiguous()
        off += n
    codebook = [k for k in out if k.endswith("vq.codebook")]
    for k in codebook:
        out[k.replace("codebook", "embed_avg")] = out[k].clone()
    if proj:
        m, d = proj[0][1]
        if any(s != (m, d) for _, s in proj) or m % d:
            raise ValueError("FAVOR+ projections of one model share one shape, rows a multiple "
                             "of the head width")
        n = len(proj)
        zb = flat[off:off + n * m * d].view(n, m // d, d, d)
        zn = flat[off + n * m * d:off + 2 * n * m * d].view(n, m, d)
        mats = _orthogonal_features(zb, zn)
        for i, (k, _) in enumerate(proj):
            out[k] = mats[i].contiguous()
    return out


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module`` (strict over its floating tensors)."""
    sd = module.state_dict()
    missing = [k for k, v in sd.items() if v.is_floating_point() and k not in weights]
    if missing:
        raise KeyError(f"no weights drawn for {missing}")
    with torch.no_grad():
        for k, v in weights.items():
            sd[k].copy_(v)
