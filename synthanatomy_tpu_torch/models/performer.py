"""Stage-2 network: the Performer AR prior.

Port of ``synthanatomy_tpu/models/performer.py`` (``Performer``): the
token, absolute-position, learned spatial-coordinate and conditioning
embeddings, hybrid FAVOR+/local-window attention blocks (ReZero or
pre-LayerNorm), the FF, the final norm and the output head, with the
full-sequence forward (``Performer.forward``) and the FAVOR projection
redraw (``redraw_projections``).  Module names follow the JAX parameter
tree (``blocks.{i}.attn.to_q``, ``token_emb``, ``abs_pos_emb``,
``spatial_embs.{i}``, ``final_norm``, ``to_out``) so
``interop.performer_from_jax`` loads strictly.

Forward options, each as in JAX: fixed sinusoidal, axial or rotary
sequence embeddings (rotary adds per-layer rotary on q/k before the
FAVOR/local split; the local heads keep their own), ``fixed`` spatial
tables, ScaleNorm, the GLU feed-forward, and ``remat_attention`` /
``reversible`` as ``torch.utils.checkpoint`` (non-reentrant) around the
attention sub-block / the whole block, with the dropout generators'
state restored for the recompute (``_remat``).

Precision follows flax under ``dtype``: parameters are held in f32;
each dense layer casts its input and weights to ``dtype`` (f32
accumulation, output in ``dtype``); embedding lookups are in ``dtype``;
LayerNorm statistics are f32 with the output in ``dtype``.  The ReZero
gains are f32 of shape (1,), so ``a * g`` promotes a bf16 residual
stream to f32 after the first gated add, as in JAX.  Attention products
take ``attn_compute_dtype`` operands.  With ``use_pallas_favor`` /
``use_pallas_local`` the attention runs through the hand-written
kernels (``ops/favor_attention.py``, ``ops/local_attention_flash.py``)
for CUDA tensors and their plain versions for CPU tensors.

Parallel training sets a process group on the modules: ``sp_group`` on
the attention (sequence parallelism), ``tp_group`` on the attention and
the FF (the Megatron split: each holds the rank's share and places the
conjugate all-reduces around its products; ``parallel/
tensor_parallel.py``).  Everything else stays the one-device forward.

The exact incremental path, as in JAX: ``init_cache`` (per block, the
FAVOR prefix state (S, z) in ``favor_cache_dtype`` and the local-head
rings of ``local_window_size`` slots in ``dtype``), ``prime_cache`` for
'prepending' conditionings and ``decode_step``.  Every block and the
local rings see ``t_global = t + n_prepend``; the rings are written in
place.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.ops.favor import (
    default_nb_features,
    favor_attention,
    favor_attention_sequence_parallel,
    favor_attention_step,
    gaussian_orthogonal_random_matrix,
)
from synthanatomy_tpu_torch.ops.local_attention import (
    apply_rotary,
    local_attention,
    local_attention_sequence_parallel,
    local_attention_step,
    rotary_sin_cos,
    rounded,
)
from synthanatomy_tpu_torch.ops.local_attention_flash import local_attention_flash
from synthanatomy_tpu_torch.parallel.distributed import group_info, megatron_f, megatron_g

__all__ = ["Performer", "redraw_projections", "spatial_coordinate_sequences",
           "spatial_lookup_layout"]


def spatial_coordinate_sequences(
    spatial_shape: Sequence[int], ordering: Ordering
) -> list:
    """Per-axis grid coordinates, raster-flattened then permuted into
    sequence order (same as the reference's helper)."""
    coords = np.meshgrid(*[np.arange(s) for s in spatial_shape], indexing="ij")
    return [np.asarray(ordering(c.reshape(-1))) for c in coords]


def spatial_lookup_layout(
    seqs: Sequence[np.ndarray], n: int, k_pre: int = 0, total: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """The BOS-right-shifted lookup of the 'absolute' spatial tables over
    ``total`` positions (default ``n``), as ``_spatial_pos_sum`` embeds
    it: position k_pre is the BOS zero row, position k_pre + q (q ≥ 1)
    takes grid cell q − 1's coordinates, at most L_grid − 1 rows carry
    one.  Returns ``(idx (total, n_axes) int32, mask (total, 1) f32)``:
    the sum at position p is ``Σᵢ tableᵢ[idx[p, i]] · mask[p]``.  The SP
    and TP train steps share it."""
    total = n if total is None else total
    idx = np.zeros((total, len(seqs)), np.int32)
    mask = np.zeros((total, 1), np.float32)
    m_rows = min(n - 1, len(seqs[0]) - 1, total - k_pre - 1)
    for i, s in enumerate(seqs):
        idx[k_pre + 1: k_pre + 1 + m_rows, i] = s[:m_rows]
    mask[k_pre + 1: k_pre + 1 + m_rows] = 1.0
    return idx, mask


def _sinusoidal_table(length: int, dim: int) -> np.ndarray:
    """(length, dim) f32 [sin | cos] table, computed in f64 as JAX does."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    sinusoid = np.einsum("i,j->ij", np.arange(length, dtype=np.float64), inv_freq)
    return np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1).astype(np.float32)


def _dense(fan_in: int, fan_out: int, bias: bool, gen, device) -> nn.Linear:
    """Linear with flax's default init: lecun-normal kernel, zero bias."""
    lin = nn.Linear(fan_in, fan_out, bias=bias, device=device)
    with torch.no_grad():
        w = torch.randn(fan_out, fan_in, generator=gen) / fan_in ** 0.5
        lin.weight.copy_(w)
        if bias:
            lin.bias.zero_()
    return lin


def _embed(num: int, dim: int, gen, device) -> nn.Embedding:
    emb = nn.Embedding(num, dim, device=device)
    with torch.no_grad():
        emb.weight.copy_(torch.randn(num, dim, generator=gen) / dim ** 0.5)
    return emb


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input and kernel cast to ``dtype``,
    the product rounded to ``dtype``, then the bias added in ``dtype``."""
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


def _row_parallel(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype, group) -> torch.Tensor:
    """This rank's share of a row-parallel ``_linear`` under tensor
    parallelism: the product of its input columns (operands rounded to
    ``dtype``, f32 accumulation) summed over ``group`` in f32 (Megatron's
    ``f``), rounded to ``dtype``, then the replicated bias added once, as
    ``_linear`` adds it."""
    y = megatron_f(F.linear(rounded(x, dtype), rounded(lin.weight, dtype)), group).to(dtype)
    return y if lin.bias is None else y + lin.bias.to(dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)``: f32 mean and E[x²] − mean²
    variance (clipped at 0), output cast to ``dtype``."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias
    return y.to(dtype)


def _lookup(emb: nn.Embedding, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Embed(dtype=dtype)``: the table cast, then indexed."""
    return emb.weight.to(dtype)[idx]


def _row(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """table[i] for a 0-d index tensor, read on the device: indexing with a
    0-d tensor reads its value on the host, which a CUDA graph cannot
    capture."""
    return table.index_select(0, i.reshape(1))[0]


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability 1 − rate and scale by
    1/(1 − rate).  Draws from ``generator`` (set by
    ``Performer.set_generator``), else from torch's default one.  With
    ``share = (rank, n)`` (the FF's hidden width split over a TP group)
    ``x`` holds the rank's n-th of the last dimension: the mask is drawn
    at the whole width, as one device draws it, and the rank's columns
    kept, so every rank advances the generator alike."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.share: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.share is None:
            draw = torch.rand(x.shape, generator=self.generator, device=x.device)
        else:
            rank, n = self.share
            w = x.shape[-1]
            draw = torch.rand(x.shape[:-1] + (w * n,), generator=self.generator,
                              device=x.device)[..., rank * w:(rank + 1) * w]
        keep = draw >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


def _remat(module: nn.Module, *args):
    """``module(*args)`` under ``torch.utils.checkpoint`` (non-reentrant),
    as ``nn.remat`` in JAX.  checkpoint restores only torch's default
    generators for the recompute; the explicit generators the dropouts in
    ``module`` draw from are set back to their state at the forward for
    the recompute (so it draws the same masks) and to their state before
    the recompute after it (so later draws do not depend on remat).  Under
    tensor parallelism the recompute runs the module's collectives
    (Megatron's ``f`` and ``g``) again; every rank of the group recomputes
    the same modules in the same order, so they pair up as in the
    forward and nothing more is needed."""
    if not torch.is_grad_enabled():
        return module(*args)
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    at_forward = [g.get_state() for g in gens]
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return module(*a)
        before = [g.get_state() for g in gens]
        for g, s in zip(gens, at_forward):
            g.set_state(s)
        try:
            return module(*a)
        finally:
            for g, s in zip(gens, before):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False)


class ScaleNorm(nn.Module):
    """x / max(‖x‖, eps) · g in f32, output in x's dtype (JAX's ScaleNorm)."""

    def __init__(self, device, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
        return (xf / torch.clamp(n, min=self.eps) * self.g).to(x.dtype)


class PerformerAttention(nn.Module):
    """Hybrid FAVOR+/local multi-head self-attention: FAVOR heads
    ``[:gh]``, local heads ``[gh:]``, outputs concatenated in that order.

    With ``sp_group`` set (JAX's ``sp_axis``; the SP train step sets it)
    the input is this rank's shard of the sequence and the heads take the
    sequence-parallel forms over that group (FAVOR's prefix state across
    ranks, the local heads' halo exchange); the kernel flags do not apply
    there, as in JAX.

    With ``tp_group`` set (the Megatron split; ``parallel/
    tensor_parallel.shard_tp_state`` sets it on a rank's share) the module
    holds the rank's packed heads: its q/k/v rows and ``to_out``'s
    columns.  The input passes through ``g``, the heads run as on one
    device (rotary, rows 5 and 6 included), ``to_out``'s partial product
    goes through ``f``, and the replicated out-bias and the dropout act
    after it, in the replicated stream: every rank of the group draws the
    same mask."""

    def __init__(self, dim, heads, dim_head, local_heads, nb_features, gen, device, *,
                 local_window=256, causal=True, generalized=False, no_projection=False,
                 qkv_bias=False, out_bias=False, dropout=0.0, scan_chunk=128,
                 use_pallas_local=False, use_pallas_favor=False,
                 attn_compute_dtype=torch.float32, favor_cache_dtype=torch.float32,
                 dtype=torch.bfloat16):
        super().__init__()
        self.sp_group = self.tp_group = None
        inner = heads * dim_head
        self.heads, self.dim_head, self.local_heads = heads, dim_head, local_heads
        self.nb_features, self.favor_cache_dtype = nb_features, favor_cache_dtype
        self.local_window, self.causal, self.generalized = local_window, causal, generalized
        self.no_projection, self.scan_chunk = no_projection, scan_chunk
        self.use_pallas_local, self.use_pallas_favor = use_pallas_local, use_pallas_favor
        self.attn_compute_dtype, self.dtype = attn_compute_dtype, dtype
        self.to_q = _dense(dim, inner, qkv_bias, gen, device)
        self.to_k = _dense(dim, inner, qkv_bias, gen, device)
        self.to_v = _dense(dim, inner, qkv_bias, gen, device)
        self.to_out = _dense(inner, dim, out_bias, gen, device)
        self.drop = Dropout(dropout)
        if heads - local_heads > 0 and not no_projection:
            self.register_buffer(
                "projection",
                gaussian_orthogonal_random_matrix(
                    nb_features, dim_head, generator=gen
                ).to(device),
            )

    def _split_heads(self, x):
        b, n, _ = x.shape
        return x.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x: torch.Tensor,
                layer_rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        b, n, _ = x.shape
        if self.tp_group is not None:
            x = megatron_g(x, self.tp_group)
        q = self._split_heads(_linear(x, self.to_q, self.dtype))
        k = self._split_heads(_linear(x, self.to_k, self.dtype))
        v = self._split_heads(_linear(x, self.to_v, self.dtype))
        if layer_rotary is not None:
            sin, cos = layer_rotary
            q = apply_rotary(q.to(torch.float32), sin[:n], cos[:n]).to(q.dtype)
            k = apply_rotary(k.to(torch.float32), sin[:n], cos[:n]).to(k.dtype)
        gh = self.heads - self.local_heads
        cd = self.attn_compute_dtype
        outs = []
        if self.sp_group is not None:
            if not self.causal or layer_rotary is not None:
                raise NotImplementedError("sequence parallelism supports causal attention "
                                          "without per-layer rotary")
            if gh > 0:
                outs.append(favor_attention_sequence_parallel(
                    q[:, :gh], k[:, :gh], v[:, :gh],
                    None if self.no_projection else self.projection, group=self.sp_group,
                    generalized=self.generalized, chunk=self.scan_chunk, compute_dtype=cd))
            if self.local_heads > 0:
                outs.append(local_attention_sequence_parallel(
                    q[:, gh:], k[:, gh:], v[:, gh:], window=self.local_window,
                    group=self.sp_group, compute_dtype=cd))
        elif gh > 0:
            outs.append(favor_attention(
                q[:, :gh], k[:, :gh], v[:, :gh],
                None if self.no_projection else self.projection,
                causal=self.causal, generalized=self.generalized, chunk=self.scan_chunk,
                compute_dtype=cd, use_pallas_scan=self.use_pallas_favor))
        if self.local_heads > 0 and self.sp_group is None:
            local = local_attention_flash if self.use_pallas_local else local_attention
            outs.append(local(q[:, gh:], k[:, gh:], v[:, gh:], window=self.local_window,
                              causal=self.causal, compute_dtype=cd))
        out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        out = out.transpose(1, 2).reshape(b, n, -1)
        if self.tp_group is not None:
            return self.drop(_row_parallel(out, self.to_out, self.dtype, self.tp_group))
        return self.drop(_linear(out, self.to_out, self.dtype))

    # -- incremental decoding -------------------------------------------------

    def init_cache(self, batch: int) -> dict:
        """Zeroed per-layer cache: S (B, gh, m, dh) and z (B, gh, m) in
        ``favor_cache_dtype`` (m is dh without a projection), rings ck, cv
        (B, lh, window, dh) in ``dtype``."""
        gh = self.heads - self.local_heads
        m = self.dim_head if self.no_projection else self.nb_features
        dev = self.to_q.weight.device
        cache = {}
        if gh > 0:
            cache["S"] = torch.zeros(batch, gh, m, self.dim_head, dtype=self.favor_cache_dtype,
                                     device=dev)
            cache["z"] = torch.zeros(batch, gh, m, dtype=self.favor_cache_dtype, device=dev)
        if self.local_heads > 0:
            shape = (batch, self.local_heads, self.local_window, self.dim_head)
            cache["ck"] = torch.zeros(shape, dtype=self.dtype, device=dev)
            cache["cv"] = torch.zeros(shape, dtype=self.dtype, device=dev)
        return cache

    def step(self, x_t: torch.Tensor, cache: dict, t: torch.Tensor,
             layer_rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x_t (B, dim) at position ``t`` (0-d tensor) → (out_t (B, dim),
        cache), the cache updated in place; FAVOR heads first, then local
        heads, as in the forward.  ``layer_rotary`` is the (sin, cos) row
        at ``t``, each (1, dh)."""
        b = x_t.shape[0]
        q, k, v = (_linear(x_t, lin, self.dtype).reshape(b, self.heads, self.dim_head)
                   for lin in (self.to_q, self.to_k, self.to_v))
        if layer_rotary is not None:
            sin, cos = layer_rotary
            q = apply_rotary(q.to(torch.float32)[..., None, :], sin, cos)[..., 0, :].to(q.dtype)
            k = apply_rotary(k.to(torch.float32)[..., None, :], sin, cos)[..., 0, :].to(k.dtype)
        gh = self.heads - self.local_heads
        outs = []
        if gh > 0:
            o, _ = favor_attention_step(
                q[:, :gh], k[:, :gh], v[:, :gh], (cache["S"], cache["z"]),
                None if self.no_projection else self.projection, generalized=self.generalized)
            outs.append(o)
        if self.local_heads > 0:
            o, _, _ = local_attention_step(
                q[:, gh:], k[:, gh:], v[:, gh:], cache["ck"], cache["cv"], t,
                window=self.local_window)
            outs.append(o)
        out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        return _linear(out.reshape(b, -1), self.to_out, self.dtype), cache


class FeedForward(nn.Module):
    """Dense → GELU (tanh) → dropout → Dense; with ``glu`` the first
    Dense is 2·inner wide and its halves a, g give a·gelu(g).

    With ``tp_group`` set the module holds the rank's share of the hidden
    width: w1's rows (under ``glu`` packed as [a_p; g_p], so ``chunk``
    still pairs each value with its gate) and w2's columns.  The input
    passes through ``g``; the hidden dropout draws the whole width's mask
    and keeps the rank's columns; w2's partial product goes through ``f``
    and its replicated bias is added once after it."""

    def __init__(self, dim, mult, gen, device, *, glu=False, dropout=0.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype, self.glu = dtype, glu
        inner = dim * mult
        self.w1 = _dense(dim, inner * 2 if glu else inner, True, gen, device)
        self.w2 = _dense(inner, dim, True, gen, device)
        self.drop = Dropout(dropout)
        self.tp_group = None

    @property
    def tp_group(self):
        return self._tp_group

    @tp_group.setter
    def tp_group(self, group):
        self._tp_group = group
        self.drop.share = None if group is None else group_info(group)

    def forward(self, x: torch.Tensor, deterministic: bool = False) -> torch.Tensor:
        if self.tp_group is not None:
            x = megatron_g(x, self.tp_group)
        h = _linear(x, self.w1, self.dtype)
        if self.glu:
            a, g = h.chunk(2, dim=-1)
            h = a * F.gelu(g, approximate="tanh")
        else:
            h = F.gelu(h, approximate="tanh")
        h = h if deterministic else self.drop(h)
        if self.tp_group is not None:
            return _row_parallel(h, self.w2, self.dtype, self.tp_group)
        return _linear(h, self.w2, self.dtype)


class PerformerBlock(nn.Module):
    """ReZero or pre-norm block; ``sp_group`` (JAX's ``sp_axis``) is the
    attention's sequence-parallel group, ``tp_group`` the tensor-parallel
    group of its split attention and FF (setting it splits both; the
    norms and ReZero gains stay replicated)."""

    def __init__(self, dim, heads, dim_head, local_heads, nb_features, ff_mult,
                 use_rezero, gen, device, *, ff_dropout=0.0, ff_glu=False, use_scalenorm=False,
                 remat_attention=False, dtype=torch.bfloat16, **attn_kw):
        super().__init__()
        self.use_rezero, self.remat_attention, self.dtype = use_rezero, remat_attention, dtype
        self.attn = PerformerAttention(
            dim, heads, dim_head, local_heads, nb_features, gen, device, dtype=dtype,
            **attn_kw,
        )
        self.ff = FeedForward(dim, ff_mult, gen, device, glu=ff_glu, dropout=ff_dropout,
                              dtype=dtype)
        if use_rezero:
            # ReZero gains start at zero (identity blocks), as in the
            # reference; shape (1,) and f32, so that they promote
            self.g_attn = nn.Parameter(torch.zeros(1, device=device))
            self.g_ff = nn.Parameter(torch.zeros(1, device=device))
            self.norm_attn = self.norm_ff = None
        elif use_scalenorm:
            self.norm_attn = ScaleNorm(device)
            self.norm_ff = ScaleNorm(device)
        else:
            self.norm_attn = nn.LayerNorm(dim, eps=1e-6, device=device)
            self.norm_ff = nn.LayerNorm(dim, eps=1e-6, device=device)

    @property
    def sp_group(self):
        return self.attn.sp_group

    @sp_group.setter
    def sp_group(self, group):
        self.attn.sp_group = group

    @property
    def tp_group(self):
        return self.attn.tp_group if self.attn.tp_group is not None else self.ff.tp_group

    @tp_group.setter
    def tp_group(self, group):
        self.attn.tp_group = self.ff.tp_group = group

    def _norm(self, x, norm):
        if norm is None:  # ReZero
            return x
        if isinstance(norm, ScaleNorm):
            return norm(x)
        return _layer_norm(x, norm, self.dtype)

    def forward(self, x: torch.Tensor,
                layer_rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        xa = self._norm(x, self.norm_attn)
        if self.remat_attention:
            a = _remat(self.attn, xa, layer_rotary)
        else:
            a = self.attn(xa, layer_rotary)
        x = x + (a * self.g_attn if self.use_rezero else a)
        f = self.ff(self._norm(x, self.norm_ff))
        return x + (f * self.g_ff if self.use_rezero else f)

    def init_cache(self, batch: int) -> dict:
        return self.attn.init_cache(batch)

    def step(self, x_t: torch.Tensor, cache: dict, t: torch.Tensor,
             layer_rotary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x_t (B, dim) → (x_t after the block, cache), no dropout."""
        a, cache = self.attn.step(self._norm(x_t, self.norm_attn), cache, t, layer_rotary)
        x_t = x_t + (a * self.g_attn if self.use_rezero else a)
        f = self.ff(self._norm(x_t, self.norm_ff), deterministic=True)
        return x_t + (f * self.g_ff if self.use_rezero else f), cache


class Performer(nn.Module):
    """Performer prior (see module docstring).  Sequences are (B, L) int
    tokens with the BOS slot at ``num_tokens - 1``."""

    def __init__(
        self,
        num_tokens: int,
        max_seq_len: int,
        dim: int,
        depth: int,
        heads: int,
        dim_head: int = 64,
        local_attn_heads: int = 0,
        local_window_size: int = 256,
        ff_mult: int = 4,
        nb_features: Optional[int] = None,
        use_rezero: bool = False,
        tie_embed: bool = False,
        spatial_position_emb: Optional[str] = None,
        spatial_shape: Optional[Tuple[int, ...]] = None,
        ordering: Optional[Ordering] = None,
        conditioning_num_tokens: Optional[Tuple[int, ...]] = None,
        conditioning_type: str = "none",
        *,
        causal: bool = True,
        feature_redraw_interval: int = 1000,
        emb_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        attn_dropout: float = 0.0,
        generalized_attention: bool = False,
        no_projection: bool = False,
        qkv_bias: bool = False,
        attn_out_bias: bool = False,
        scan_chunk: int = 128,
        use_pallas_local: bool = False,
        use_pallas_favor: bool = False,
        attn_compute_dtype: torch.dtype = torch.float32,
        dtype: torch.dtype = torch.bfloat16,
        rotary_position_emb: bool = False,
        fixed_position_emb: bool = False,
        axial_position_emb: bool = False,
        use_scalenorm: bool = False,
        ff_glu: bool = False,
        reversible: bool = False,
        remat_attention: bool = False,
        axial_position_shape: Optional[Tuple[int, int]] = None,
        favor_cache_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        if rotary_position_emb + fixed_position_emb + axial_position_emb > 1:
            raise ValueError("rotary_position_emb, fixed_position_emb and axial_position_emb "
                             "are mutually exclusive")
        if spatial_position_emb not in (None, "fixed", "absolute"):
            raise ValueError("spatial_position_emb must be 'fixed' or 'absolute', got "
                             f"{spatial_position_emb!r}")
        if spatial_position_emb is not None and (spatial_shape is None or ordering is None):
            raise ValueError("spatial_position_emb requires spatial_shape and ordering")
        if conditioning_type not in ("none", "bos_replacement", "prepending"):
            raise ValueError(f"unknown conditioning_type {conditioning_type!r}")
        self.num_tokens = num_tokens
        self.max_seq_len = max_seq_len
        self.dim = dim
        self.depth = depth
        self.heads = heads
        self.dim_head = dim_head
        self.local_attn_heads = local_attn_heads
        self.local_window_size = local_window_size
        self.ff_mult = ff_mult
        self.nb_features = nb_features or default_nb_features(dim_head)
        self.use_rezero = use_rezero
        self.tie_embed = tie_embed
        self.spatial_position_emb = spatial_position_emb
        self.conditioning_type = conditioning_type
        self.conditioning_num_tokens = tuple(conditioning_num_tokens or ())
        self.causal = causal
        self.feature_redraw_interval = feature_redraw_interval
        self.generalized_attention = generalized_attention
        self.no_projection = no_projection
        self.qkv_bias, self.attn_out_bias = qkv_bias, attn_out_bias
        self.rotary_position_emb, self.fixed_position_emb = rotary_position_emb, fixed_position_emb
        self.axial_position_emb = axial_position_emb
        self.use_scalenorm, self.ff_glu = use_scalenorm, ff_glu
        self.reversible, self.remat_attention = reversible, remat_attention
        self.dtype = dtype
        gen = generator

        n_pre = (len(self.conditioning_num_tokens)
                 if conditioning_type == "prepending" else 0)
        seq = max_seq_len + n_pre
        self.token_emb = _embed(num_tokens, dim, gen, device)
        # the sequence-level positional embedding
        if rotary_position_emb or fixed_position_emb:
            self.register_buffer("fixed_pos", torch.from_numpy(_sinusoidal_table(seq, dim)).to(
                device), persistent=False)
        elif axial_position_emb:
            s0, s1 = axial_position_shape or (math.ceil(seq / 64), 64)
            self.axial_emb_0 = nn.Parameter(torch.randn(s0, 1, dim, generator=gen).to(device))
            self.axial_emb_1 = nn.Parameter(torch.randn(1, s1, dim, generator=gen).to(device))
        else:
            self.abs_pos_emb = _embed(seq, dim, gen, device)
        self._spatial_sequences = []
        if spatial_position_emb is not None:
            self._spatial_sequences = spatial_coordinate_sequences(spatial_shape, ordering)
            if spatial_position_emb == "absolute":
                self.spatial_embs = nn.ModuleList(
                    [_embed(len(s), dim, gen, device) for s in self._spatial_sequences]
                )
                for i, s in enumerate(self._spatial_sequences):  # for the decode step
                    self.register_buffer(f"spatial_coords_{i}",
                                         torch.from_numpy(s).long().to(device), persistent=False)
            else:
                for i, s in enumerate(self._spatial_sequences):
                    table = _sinusoidal_table(int(s.max()) + 1, dim)[s]
                    self.register_buffer(f"spatial_fixed_{i}", torch.from_numpy(table).to(device),
                                         persistent=False)
        if self.conditioning_num_tokens:
            self.conditioning_embs = nn.ModuleList(
                [_embed(n, dim, gen, device) for n in self.conditioning_num_tokens]
            )
        self.emb_drop = Dropout(emb_dropout)
        attn_kw = dict(
            local_window=local_window_size, causal=causal, generalized=generalized_attention,
            no_projection=no_projection, qkv_bias=qkv_bias, out_bias=attn_out_bias,
            dropout=attn_dropout, scan_chunk=scan_chunk, use_pallas_local=use_pallas_local,
            use_pallas_favor=use_pallas_favor, attn_compute_dtype=attn_compute_dtype,
            favor_cache_dtype=favor_cache_dtype,
        )
        self.blocks = nn.ModuleList([
            PerformerBlock(dim, heads, dim_head, local_attn_heads, self.nb_features,
                           ff_mult, use_rezero, gen, device, ff_dropout=ff_dropout,
                           ff_glu=ff_glu, use_scalenorm=use_scalenorm,
                           remat_attention=remat_attention, dtype=dtype, **attn_kw)
            for _ in range(depth)
        ])
        self.final_norm = nn.LayerNorm(dim, eps=1e-6, device=device)
        if not tie_embed:
            self.to_out = _dense(dim, num_tokens, True, gen, device)

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every dropout draws from."""
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator

    def position_table(self, n: int) -> torch.Tensor:
        """(n, dim) f32: everything position-dependent added to a decoded
        token's embedding — the positional row plus the BOS-right-shifted
        spatial coordinate rows (zero row at position 0), as JAX's
        ``combined_position_table`` builds it: learned rows are lookups in
        ``dtype`` (their spatial axes summed in ``dtype``), fixed and axial
        tables f32."""
        pos = self._pos_emb(n).float()
        sp = self._spatial_pos_sum(n)
        return pos if sp is None else pos + sp[0].float()

    # -- full-sequence forward ----------------------------------------------

    def _spatial_pos_sum(self, n: int) -> Optional[torch.Tensor]:
        """(1, n, dim) Σ per-axis coordinate embeddings (in ``dtype`` for
        the learned tables, f32 for the fixed ones), right-shifted for BOS:
        position 0 gets zeros, position p ≥ 1 the coordinates of grid cell
        p − 1, positions past the grid zeros."""
        if self.spatial_position_emb is None:
            return None
        total = None
        dev = self.token_emb.weight.device
        for i, seq in enumerate(self._spatial_sequences):
            if self.spatial_position_emb == "absolute":
                rows = _lookup(self.spatial_embs[i], torch.as_tensor(seq[:-1], device=dev),
                               self.dtype)
            else:
                rows = getattr(self, f"spatial_fixed_{i}")[:-1]
            rows = rows[: n - 1]
            rows = F.pad(rows, (0, 0, 1, n - 1 - rows.shape[0]))
            total = rows if total is None else total + rows
        return total[None]

    def _pos_emb(self, n: int) -> torch.Tensor:
        """(n, dim) sequence positional rows: the fixed table (f32), the
        axial sum (f32) or the learned lookup (``dtype``)."""
        if self.rotary_position_emb or self.fixed_position_emb:
            return self.fixed_pos[:n]
        if self.axial_position_emb:
            return (self.axial_emb_0 + self.axial_emb_1).reshape(-1, self.dim)[:n]
        return _lookup(self.abs_pos_emb, torch.arange(n, device=self.abs_pos_emb.weight.device),
                       self.dtype)

    def _embed_prefix(self, x, conditionings):
        h = _lookup(self.token_emb, x, self.dtype)
        sp = self._spatial_pos_sum(h.shape[1])
        if sp is not None:
            h = h + sp.to(h.dtype)
        if conditionings is not None and self.conditioning_type != "none":
            b = h.shape[0]
            embs = [_lookup(emb, torch.as_tensor(c, device=h.device), self.dtype)
                    .reshape(b, 1, self.dim)
                    for emb, c in zip(self.conditioning_embs, conditionings)]
            if self.conditioning_type == "bos_replacement":
                c = torch.zeros_like(h[:, :1])
                for e in embs:
                    c = c + e
                h = torch.cat([c, h[:, 1:]], dim=1)
            else:  # prepending
                h = torch.cat(embs + [h], dim=1)
        return h

    def forward(
        self,
        x: torch.Tensor,
        conditionings: Optional[Sequence[torch.Tensor]] = None,
        *,
        return_encodings: bool = False,
    ) -> torch.Tensor:
        """x: (B, L) int tokens → (B, L, num_tokens) logits in ``dtype``
        (conditioning positions stripped in 'prepending' mode).  Dropout
        is on in ``train()`` mode."""
        h = self.emb_drop(self.embed(x, conditionings))
        h = self.apply_blocks(h, self.blocks)
        h = self.encode(h, conditionings)
        if return_encodings:
            return h
        return self._head(h)

    def embed(self, x: torch.Tensor,
              conditionings: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The residual stream before the first block, without dropout:
        token, spatial and conditioning embeddings plus the positional rows
        (JAX's ``_embed_prefix`` + ``_pos_emb``)."""
        if x.shape[1] > self.max_seq_len:
            raise ValueError(f"sequence length {x.shape[1]} must be ≤ max_seq_len "
                             f"{self.max_seq_len}")
        h = self._embed_prefix(x, conditionings)
        return h + self._pos_emb(h.shape[1])[None].to(h.dtype)

    def apply_blocks(self, h: torch.Tensor, blocks: Sequence[PerformerBlock]) -> torch.Tensor:
        """``blocks`` (this model's, or a contiguous run of them) on the
        stream ``h``, with the rotary table and the reversible remat."""
        rotary = (rotary_sin_cos(self.dim_head, torch.arange(h.shape[1], device=h.device))
                  if self.rotary_position_emb else None)
        for blk in blocks:
            h = _remat(blk, h, rotary) if self.reversible else blk(h, rotary)
        return h

    def encode(self, h: torch.Tensor,
               conditionings: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """The final norm of the last block's stream, 'prepending'
        positions stripped: the encodings ``_head`` maps to logits."""
        h = _layer_norm(h, self.final_norm, self.dtype)
        if conditionings is not None and self.conditioning_type == "prepending":
            h = h[:, len(self.conditioning_embs):]
        return h

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        if self.tie_embed:
            return h @ self.token_emb.weight.T.to(h.dtype)
        return _linear(h, self.to_out, self.dtype)

    # -- incremental decoding -------------------------------------------------

    @property
    def n_prepend(self) -> int:
        """Positions the 'prepending' conditionings take before the tokens."""
        return len(self.conditioning_num_tokens) if self.conditioning_type == "prepending" else 0

    def init_cache(self, batch: int) -> list:
        """One zeroed cache per block (``PerformerAttention.init_cache``)."""
        return [blk.init_cache(batch) for blk in self.blocks]

    def _run_blocks_step(self, h: torch.Tensor, cache: list, t_global: torch.Tensor):
        rotary = (rotary_sin_cos(self.dim_head, t_global.reshape(1))
                  if self.rotary_position_emb else None)
        for blk, blk_cache in zip(self.blocks, cache):
            h, _ = blk.step(h, blk_cache, t_global, rotary)
        return h, cache

    def prime_cache(self, cache: list, conditionings: Sequence[torch.Tensor]) -> list:
        """'prepending': push the conditioning embeddings through the
        stack as positions 0 .. n_prepend − 1, each with its positional
        row and no spatial row; their logits are dropped, as the batch
        path strips them.  The cache is updated in place."""
        pos = self._pos_emb(self.max_seq_len + self.n_prepend)
        for idx, (emb, c) in enumerate(zip(self.conditioning_embs, conditionings)):
            h = _lookup(emb, torch.as_tensor(c, device=pos.device), self.dtype).reshape(-1, self.dim)
            self._run_blocks_step(h + pos[idx].to(h.dtype), cache,
                                  torch.tensor(idx, device=pos.device))
        return cache

    def _pos_emb_at(self, t_global: torch.Tensor) -> torch.Tensor:
        """(dim,) sequence positional row at one position: the sinusoid
        computed in f32 at ``t_global`` (as JAX does in the step), the
        axial sum, or the learned row in ``dtype``."""
        if self.rotary_position_emb or self.fixed_position_emb:
            exps = torch.arange(0, self.dim, 2, dtype=torch.float32, device=t_global.device)
            s = t_global.to(torch.float32) * (1.0 / torch.pow(10000.0, exps / self.dim))
            return torch.cat([torch.sin(s), torch.cos(s)])
        if self.axial_position_emb:
            s1 = self.axial_emb_1.shape[1]
            return _row(self.axial_emb_0[:, 0], t_global // s1) + _row(self.axial_emb_1[0],
                                                                       t_global % s1)
        return _row(self.abs_pos_emb.weight, t_global).to(self.dtype)

    def _spatial_pos_at(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """(dim,) Σ per-axis coordinate rows at token position ``t``: zeros
        at 0 (BOS), the coordinates of grid cell t − 1 (clamped to the
        grid) after."""
        if self.spatial_position_emb is None:
            return None
        total = None
        for i, seq in enumerate(self._spatial_sequences):
            src = torch.clamp(t - 1, 0, len(seq) - 1)
            if self.spatial_position_emb == "absolute":
                coord = _row(getattr(self, f"spatial_coords_{i}"), src)
                row = _row(self.spatial_embs[i].weight, coord).to(self.dtype)
            else:
                row = _row(getattr(self, f"spatial_fixed_{i}"), src)
            total = row if total is None else total + row
        return torch.where(t == 0, torch.zeros_like(total), total)

    def decode_step(
        self,
        token_t: torch.Tensor,
        cache: list,
        t,
        conditionings: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, list]:
        """token_t (B,) at token position ``t`` (0 = BOS; an int or a 0-d
        integer tensor on the model's device) → (logits (B, num_tokens) in
        ``dtype``, cache), the cache updated in place.  'bos_replacement'
        replaces the whole t = 0 embedding (spatial row included) by the
        conditioning sum; 'prepending' needs :meth:`prime_cache` first.
        With t a device tensor the step reads no host value, so a CUDA
        graph can capture it (``models/sampling.py``)."""
        t = torch.as_tensor(t, device=token_t.device)
        h = _lookup(self.token_emb, token_t, self.dtype)
        sp = self._spatial_pos_at(t)
        if sp is not None:
            h = h + sp.to(h.dtype)
        if conditionings is not None and self.conditioning_type == "bos_replacement":
            c = torch.zeros_like(h)
            for emb, cond in zip(self.conditioning_embs, conditionings):
                c = c + _lookup(emb, torch.as_tensor(cond, device=h.device),
                                self.dtype).reshape(h.shape)
            h = torch.where(t == 0, c, h)
        t_global = t + self.n_prepend
        h, cache = self._run_blocks_step(h + self._pos_emb_at(t_global).to(h.dtype), cache,
                                         t_global)
        return self._head(_layer_norm(h, self.final_norm, self.dtype)), cache


@torch.no_grad()
def redraw_projections(model: Performer, generator: torch.Generator) -> None:
    """Redraw every layer's FAVOR+ projection buffer in place from
    ``generator`` (a CPU generator: the QR factorisations run on the
    host) — the port of ``redraw_projections`` (performer.py:845).  A
    layer that this process does not hold (a pipeline stage's stand-in
    for another stage's block, which has no ``attn``) draws its matrix
    too and drops it, so every layer's draw is the one a process holding
    the whole model makes."""
    shape = next((tuple(blk.attn.projection.shape) for blk in model.blocks
                  if getattr(getattr(blk, "attn", None), "projection", None) is not None), None)
    if shape is None:
        return
    for blk in model.blocks:
        proj = gaussian_orthogonal_random_matrix(*shape, generator=generator)
        if hasattr(blk, "attn"):
            blk.attn.projection.copy_(proj)
