"""Sequence-parallel (context-parallel) training of the Performer prior.

Port of ``synthanatomy_tpu/parallel/sequence_parallel.py``.  Every rank
of the seq group holds the whole (replicated) model and L/P of each
sequence's tokens.  Only the attention talks across ranks: the FAVOR+
heads pass their prefix state along the ranks
(``ops.favor.favor_attention_sequence_parallel``), the local heads
exchange a halo of ``window`` keys and values with the next rank
(``ops.local_attention.local_attention_sequence_parallel``).  The rest
(embeddings, norms, projections, FF, CE) is per token.  Gradients are
summed over the seq group (and the data group of a DP×SP layout), as JAX
``psum``-s them; the step equals the one-device step up to rounding.

Sequences are right-padded so that each rank's shard is a multiple of
the local window; the padding is masked out of the loss and, attention
being causal, seen by no real token.  The positional tables are
zero-extended past ``max_seq_len`` for it, so the canonical model (the
one-device checkpoint's shapes) trains.  As in JAX, the SP path takes
the plain attention forms: the kernel flags do not apply to it.

The step keeps the port's convention: the state carries the optimizer
(JAX's ``tx``) and the model trains in place.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from synthanatomy_tpu_torch.models.performer import (
    Performer,
    _lookup,
    redraw_projections,
    spatial_lookup_layout,
)
from synthanatomy_tpu_torch.parallel import distributed as D

__all__ = ["make_sp_train_step", "sp_padded_length"]

_EPS = 1e-6


def sp_padded_length(model: Performer, seq_len: int, n_shards: int) -> int:
    """``l_pad``: ``seq_len`` plus the 'prepending' prefix, rounded up to
    ``n_shards`` × the local window (× 1 without local heads)."""
    k_pre = model.n_prepend if model.conditioning_num_tokens else 0
    align = n_shards * (model.local_window_size if model.local_attn_heads else 1)
    return -(-(seq_len + k_pre) // align) * align


def _const_pos_rows(model: Performer, n: int, k_pre: int) -> torch.Tensor:
    """(n, D) f32 positional rows that are no parameters: the fixed
    sinusoidal table (zero past its end: those are loss-masked pad
    positions) and the 'fixed' spatial rows, which belong to the tokens
    and so start after the ``k_pre`` prefix rows (JAX's
    ``_const_pos_method``).  Learned tables are looked up in the loss."""
    dev = model.token_emb.weight.device
    total = torch.zeros(n, model.dim, device=dev)
    if model.fixed_position_emb:
        fp = model.fixed_pos[:n].float()
        total = total + F.pad(fp, (0, 0, 0, n - fp.shape[0]))
    if model.spatial_position_emb == "fixed":
        sp = model._spatial_pos_sum(n - k_pre)[0].float()
        total = total + F.pad(sp, (0, 0, k_pre, 0))
    return total


@contextlib.contextmanager
def _sharded_attention(model: Performer, group):
    """The blocks' attention in its sequence-parallel form over ``group``
    for the length of the block (forward and backward: a remat recompute
    runs the attention again)."""
    for blk in model.blocks:
        blk.sp_group = group
    try:
        yield
    finally:
        for blk in model.blocks:
            blk.sp_group = None


def make_sp_train_step(
    model: Performer,
    seq_group,
    seq_len: int,
    *,
    data_group=None,
) -> Callable:
    """``step(state, inputs, targets, conditionings, sched) -> (state,
    metrics)`` over this rank's shard of the sequence.

    ``inputs``/``targets`` are this rank's rows of the global batch (its
    data group's share; the whole batch without one), each the full
    sequence of ``seq_len`` tokens: the step pads them to ``l_pad`` and
    takes the rank's ``l_pad / P`` columns, P the size of ``seq_group``.
    With ``data_group`` (the DP×SP layout) the ranks of one data group
    hold the same columns of other rows, and gradients sum over both.

    Conditioning as in JAX: 'bos_replacement' replaces global position 0,
    which rank 0 of the seq group holds; 'prepending' puts its k rows at
    the head of the global sequence (rank 0's), their logits masked out.
    Raises as JAX does for rotary or axial positions, any dropout, missing
    or unexpected ``conditionings`` and a sequence beyond ``l_pad``."""
    if model.rotary_position_emb or model.axial_position_emb:
        raise NotImplementedError("SP training supports absolute/fixed positional embeddings")
    if any(m.rate for m in model.modules() if hasattr(m, "rate")):
        raise NotImplementedError("SP training runs the blocks deterministically; dropout "
                                  "(emb/ff/attn) is unsupported — use DP or single-device")
    cond_type = model.conditioning_type if model.conditioning_num_tokens else "none"
    n_cond = len(model.conditioning_num_tokens)
    k_pre = n_cond if cond_type == "prepending" else 0
    s_rank, n_sh = D.group_info(seq_group)
    l_pad = sp_padded_length(model, seq_len, n_sh)
    ls = l_pad // n_sh
    g0 = s_rank * ls
    cols = slice(g0, g0 + ls)
    d_size = D.group_info(data_group)[1]
    dev = model.token_emb.weight.device
    dtype = model.dtype
    interval = model.feature_redraw_interval
    pos_rows = _const_pos_rows(model, l_pad, k_pre)[cols]
    abs_spatial = model.spatial_position_emb == "absolute"
    if abs_spatial:
        idx, mask = spatial_lookup_layout(model._spatial_sequences, seq_len, k_pre=k_pre,
                                          total=l_pad)
        sp_idx = torch.from_numpy(idx[cols]).long().to(dev)
        sp_mask = torch.from_numpy(mask[cols]).to(dev)

    def loss_fn(inputs, targets, mask, conds):
        h = _lookup(model.token_emb, inputs, dtype)
        if cond_type == "bos_replacement" and s_rank == 0:
            c = torch.zeros(h.shape[0], model.dim, device=dev)
            for emb, cond in zip(model.conditioning_embs, conds):
                c = c + emb.weight.float()[cond]
            h = torch.cat([c.to(h.dtype)[:, None], h[:, 1:]], dim=1)
        elif cond_type == "prepending":
            h = h.clone()
            for j, (emb, cond) in enumerate(zip(model.conditioning_embs, conds)):
                if g0 <= j < g0 + ls:  # this rank holds global position j
                    h[:, j - g0] = emb.weight.to(dtype)[cond]
        if not model.fixed_position_emb:
            table = model.abs_pos_emb.weight
            table = F.pad(table, (0, 0, 0, max(l_pad - table.shape[0], 0)))
            h = h + table[cols].to(h.dtype)
        h = h + pos_rows.to(h.dtype)
        if abs_spatial:
            srow = torch.zeros(ls, model.dim, device=dev)
            for j, emb in enumerate(model.spatial_embs):
                srow = srow + emb.weight.float()[sp_idx[:, j]]
            h = h + (srow * sp_mask).to(h.dtype)[None]
        for blk in model.blocks:
            h = blk(h)
        h32 = h.float()
        mu = h32.mean(-1, keepdim=True)
        var = (h32 - mu).square().mean(-1, keepdim=True)
        hn = (h32 - mu) * torch.rsqrt(var + _EPS) * model.final_norm.weight \
            + model.final_norm.bias
        if model.tie_embed:
            logits = hn.to(dtype) @ model.token_emb.weight.to(dtype).T
        else:
            logits = F.linear(hn.to(dtype), model.to_out.weight.to(dtype)) + model.to_out.bias
        lse = torch.log_softmax(logits.float(), dim=-1)
        nll = -lse.gather(-1, targets[..., None].long())[..., 0]
        # the local part of the global mean (every rank holds b rows of n
        # real tokens); the gradient sum over the ranks gives the mean's
        return (nll * mask).sum()

    def step(state, inputs, targets, conditionings: Optional[Sequence[torch.Tensor]],
             sched: Dict[str, float]):
        b, n = inputs.shape
        if n + k_pre > l_pad:
            raise ValueError(f"sequence {n} exceeds padded capacity {l_pad}")
        if (conditionings is None) != (cond_type == "none"):
            raise ValueError(f"model conditioning_type={cond_type!r} but conds "
                             f"{'missing' if conditionings is None else 'given'}")
        pad = (k_pre, l_pad - n - k_pre)
        mask = F.pad(torch.ones(b, n, device=inputs.device), pad)[:, cols]
        x = F.pad(inputs, pad)[:, cols]
        y = F.pad(targets, pad)[:, cols]
        conds = [torch.as_tensor(c, device=dev).long() for c in conditionings or ()]
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with _sharded_attention(model, seq_group):
            loss = loss_fn(x, y, mask, conds) / float(b * n * d_size)
            loss.backward()
        # a parameter this rank's shard does not reach (a conditioning
        # table off rank 0) still joins the sum, with a zero gradient
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params] + [loss.detach().reshape(1)]
        for group in (seq_group, data_group):
            D.sum_(grads, group)
        for group_ in state.optimizer.param_groups:
            group_["lr"] = float(sched["lr"])
        state.optimizer.step()
        state.step += 1
        state.steps_since_redraw += 1
        if interval and state.steps_since_redraw >= interval:
            redraw_projections(model, state.redraw_generator)
            state.steps_since_redraw = 0
        return state, {"Loss": grads[-1][0]}

    return step
