"""Blocked local-window causal attention, plain PyTorch.

Port of ``synthanatomy_tpu/ops/local_attention.py``: ``rotary_sin_cos``,
``apply_rotary`` and ``local_attention`` (the XLA path).  A query at
position ``i`` attends to keys ``j`` with ``i - window < j <= i`` and
``j >= 0`` (causal), or ``|i - j| < window`` (non-causal).  Rotary
phases and the softmax run in f32; the two products take operands in
``compute_dtype`` and accumulate in f32 (a bf16 operand is exact in
f32, so a f32 product of bf16-rounded operands is the TPU's bf16
matmul with f32 accumulation).

``local_attention_step`` is the ring-buffer form of the exact decode
path.  The sequence-parallel variant is not ported yet (ROADMAP §1).
The banded kernel for the training path is
``ops/local_attention_flash.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rotary_sin_cos", "apply_rotary", "local_attention", "local_attention_step",
           "rounded"]


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in f32: the operand of a
    product with ``dtype`` inputs and f32 accumulation."""
    return x.to(dtype).to(torch.float32)


def rotary_sin_cos(dim: int, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, dim) sin and cos tables, GPT-NeoX layout (frequencies
    duplicated across the two halves)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = 1.0 / torch.pow(10000.0, exps)  # a Python base: no host-to-card copy
    freqs = positions.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., L, d); sin/cos: (L, d), broadcast over leading dims."""
    return x * cos + _rotate_half(x) * sin


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    causal: bool = True,
    use_rotary: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """q, k, v: (B, H, L, d) → (B, H, L, d) in v's dtype.

    Buckets of ``window`` rows, each attending to itself and the
    previous bucket, as the JAX function lays it out."""
    b, h, n, d = q.shape
    in_dtype = v.dtype
    scale = d ** -0.5
    if use_rotary:
        sin, cos = rotary_sin_cos(d, torch.arange(n, device=q.device))
        q = apply_rotary(q.to(torch.float32), sin, cos)
        k = apply_rotary(k.to(torch.float32), sin, cos)
    cd = compute_dtype
    q, k, v = rounded(q, cd), rounded(k, cd), rounded(v, cd)
    pad = (-n) % window
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    nb = (n + pad) // window
    qb = q.reshape(b, h, nb, window, d)
    kb = k.reshape(b, h, nb, window, d)
    vb = v.reshape(b, h, nb, window, d)
    k2 = torch.cat([torch.roll(kb, 1, dims=2), kb], dim=3)  # (b, h, nb, 2w, d)
    v2 = torch.cat([torch.roll(vb, 1, dims=2), vb], dim=3)
    scores = torch.einsum("bhnid,bhnjd->bhnij", qb, k2) * scale

    q_pos = torch.arange(n + pad, device=q.device).reshape(nb, window)
    k_pos = torch.cat([q_pos - window, q_pos], dim=-1)
    valid = k_pos >= 0
    if causal:
        allowed = (k_pos[:, None, :] <= q_pos[:, :, None]) & (
            k_pos[:, None, :] > q_pos[:, :, None] - window)
    else:
        allowed = (k_pos[:, None, :] - q_pos[:, :, None]).abs() < window
    mask = allowed & valid[:, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhnij,bhnjd->bhnid", rounded(probs, cd), v2)
    return out.reshape(b, h, n + pad, d)[:, :, :n].to(in_dtype)


def local_attention_step(
    q_t: torch.Tensor,
    k_t: torch.Tensor,
    v_t: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    t,
    *,
    window: int,
    use_rotary: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token at position ``t`` (an int or a 0-d integer tensor on the
    rings' device) over a ring of the last ``window`` keys.

    q_t, k_t, v_t: (B, H, d); cache_k, cache_v: (B, H, window, d) rings,
    written IN PLACE at slot ``t mod window`` (JAX returns new arrays;
    a copy of both rings per layer and token would dominate the step).
    Returns ``(out_t, cache_k, cache_v)``.  The query attends to
    positions (t − window, t], as :func:`local_attention` does; rotary at
    ``t`` is applied here, on top of any layer rotary.  Scores and the
    softmax are f32; the rings keep their own dtype."""
    d = q_t.shape[-1]
    in_dtype = v_t.dtype
    t = torch.as_tensor(t, device=cache_k.device)
    if use_rotary:
        sin, cos = rotary_sin_cos(d, t.reshape(1))
        q_t = apply_rotary(q_t.to(torch.float32)[..., None, :], sin, cos)[..., 0, :]
        k_t = apply_rotary(k_t.to(torch.float32)[..., None, :], sin, cos)[..., 0, :]
    slot = t % window
    cache_k.index_copy_(2, slot.reshape(1), k_t.to(cache_k.dtype)[:, :, None])
    cache_v.index_copy_(2, slot.reshape(1), v_t.to(cache_v.dtype)[:, :, None])
    # slots <= slot hold t - (slot - j); slots > slot a window earlier
    slots = torch.arange(window, device=q_t.device)
    k_pos = t - (slot - slots) - torch.where(slots > slot, window, 0)
    valid = (k_pos >= 0) & (k_pos > t - window) & (k_pos <= t)
    scores = torch.einsum("bhd,bhjd->bhj", q_t.to(torch.float32),
                          cache_k.to(torch.float32)) * d ** -0.5
    probs = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bhj,bhjd->bhd", probs, cache_v.to(torch.float32))
    return out.to(in_dtype), cache_k, cache_v
