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
path.  ``local_attention_sequence_parallel`` runs on a shard of the
sequence: each rank's last ``window`` keys and values go to the next
rank as the halo its first bucket attends to.  The banded kernel for the
training path is ``ops/local_attention_flash.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from synthanatomy_tpu_torch.parallel.distributed import backend_is_nccl

__all__ = ["rotary_sin_cos", "apply_rotary", "local_attention",
           "local_attention_sequence_parallel", "local_attention_step", "rounded"]


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
    position_offset: int = 0,
    halo_k: Optional[torch.Tensor] = None,
    halo_v: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """q, k, v: (B, H, L, d) → (B, H, L, d) in v's dtype.

    Buckets of ``window`` rows, each attending to itself and the
    previous bucket, as the JAX function lays it out.
    ``position_offset`` shifts the positions (rotary phases and masks) of
    a sequence shard; ``halo_k``/``halo_v`` (B, H, window, d), the
    previous shard's last keys (already rotated at their positions) and
    values, take the place of the first bucket's previous bucket.  At
    offset 0 the mask rejects them, as it does the rolled-in last bucket."""
    b, h, n, d = q.shape
    in_dtype = v.dtype
    scale = d ** -0.5
    if use_rotary:
        sin, cos = rotary_sin_cos(d, torch.arange(n, device=q.device) + position_offset)
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
    k_prev, v_prev = torch.roll(kb, 1, dims=2), torch.roll(vb, 1, dims=2)
    if halo_k is not None:
        k_prev = torch.cat([rounded(halo_k, cd)[:, :, None], k_prev[:, :, 1:]], dim=2)
        v_prev = torch.cat([rounded(halo_v, cd)[:, :, None], v_prev[:, :, 1:]], dim=2)
    k2 = torch.cat([k_prev, kb], dim=3)  # (b, h, nb, 2w, d)
    v2 = torch.cat([v_prev, vb], dim=3)
    scores = torch.einsum("bhnid,bhnjd->bhnij", qb, k2) * scale

    q_pos = torch.arange(n + pad, device=q.device).reshape(nb, window) + position_offset
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


class _ShiftRight(torch.autograd.Function):
    """Each rank of ``group`` sends ``x`` to the next rank (the last to
    rank 0) and returns what the previous one sent; backward sends the
    cotangent back the other way.  One ``batch_isend_irecv`` a direction
    (a send and a receive posted together: no ordering can deadlock).
    Over gloo the tensors go through the host: its point-to-point
    transport reads host memory."""

    @staticmethod
    def _shift(x, group, step):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        host = not backend_is_nccl(group)
        send = (x.cpu() if host else x).contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (rank + step) % world),
                          group),
               dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (rank - step) % world),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(x.device)

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ShiftRight._shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _ShiftRight._shift(grad, ctx.group, -1), None


def local_attention_sequence_parallel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    group,
    use_rotary: bool = True,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Causal local attention on this rank's shard of the sequence: q, k,
    v (B, H, L/P, d), the ranks of ``group`` holding consecutive shards in
    rank order (None: one shard) → (B, H, L/P, d) in v's dtype.

    Rotary at the global positions, then the halo exchange: the rank's
    last ``window`` rotated keys and its values go to the next rank.  The
    shard length must be a multiple of ``window``.  Equals
    :func:`local_attention` on the whole sequence up to rounding."""
    b, h, n_local, d = q.shape
    if n_local % window != 0:
        raise ValueError(f"sequence-parallel local attention needs shard length ({n_local}) "
                         f"divisible by window ({window})")
    rank, world = (0, 1) if group is None else (dist.get_rank(group),
                                                  dist.get_world_size(group))
    offset = rank * n_local
    if use_rotary:
        sin, cos = rotary_sin_cos(d, torch.arange(n_local, device=q.device) + offset)
        q = apply_rotary(q.to(torch.float32), sin, cos)
        k = apply_rotary(k.to(torch.float32), sin, cos)
    # keys and values in one exchange (f32 holds a bf16 value exactly)
    halo = torch.stack([k[:, :, -window:].to(torch.float32),
                        v[:, :, -window:].to(torch.float32)])
    if world > 1:
        halo = _ShiftRight.apply(halo, group)
    halo_k, halo_v = halo.unbind(0)
    # rank 0's halo wraps around from the last rank: its k_pos < 0 mask rejects it
    return local_attention(q, k, v, window=window, causal=True, use_rotary=False,
                           position_offset=offset, halo_k=halo_k, halo_v=halo_v,
                           compute_dtype=compute_dtype)


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
