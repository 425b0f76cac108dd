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

Not ported yet (ROADMAP §1, module 1): rotary, fixed and axial position
embeddings, ScaleNorm, GLU, ``reversible`` and ``remat_attention``
(they raise), and the exact ``decode_step`` path (sampling runs the
fused decode step, ``models/sampling.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.ops.favor import (
    default_nb_features,
    favor_attention,
    gaussian_orthogonal_random_matrix,
)
from synthanatomy_tpu_torch.ops.local_attention import local_attention
from synthanatomy_tpu_torch.ops.local_attention_flash import local_attention_flash

__all__ = ["Performer", "redraw_projections", "spatial_coordinate_sequences"]

_WAITS = "not ported yet (ROADMAP §1, module 1)"


def spatial_coordinate_sequences(
    spatial_shape: Sequence[int], ordering: Ordering
) -> list:
    """Per-axis grid coordinates, raster-flattened then permuted into
    sequence order (same as the reference's helper)."""
    coords = np.meshgrid(*[np.arange(s) for s in spatial_shape], indexing="ij")
    return [np.asarray(ordering(c.reshape(-1))) for c in coords]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


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


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability 1 − rate and scale by
    1/(1 − rate).  Draws from ``generator`` (set by
    ``Performer.set_generator``), else from torch's default one."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


class PerformerAttention(nn.Module):
    """Hybrid FAVOR+/local multi-head self-attention: FAVOR heads
    ``[:gh]``, local heads ``[gh:]``, outputs concatenated in that order."""

    def __init__(self, dim, heads, dim_head, local_heads, nb_features, gen, device, *,
                 local_window=256, causal=True, generalized=False, no_projection=False,
                 qkv_bias=False, out_bias=False, dropout=0.0, scan_chunk=128,
                 use_pallas_local=False, use_pallas_favor=False,
                 attn_compute_dtype=torch.float32, dtype=torch.bfloat16):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.local_heads = heads, dim_head, local_heads
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q = self._split_heads(_linear(x, self.to_q, self.dtype))
        k = self._split_heads(_linear(x, self.to_k, self.dtype))
        v = self._split_heads(_linear(x, self.to_v, self.dtype))
        gh = self.heads - self.local_heads
        cd = self.attn_compute_dtype
        outs = []
        if gh > 0:
            outs.append(favor_attention(
                q[:, :gh], k[:, :gh], v[:, :gh],
                None if self.no_projection else self.projection,
                causal=self.causal, generalized=self.generalized, chunk=self.scan_chunk,
                compute_dtype=cd, use_pallas_scan=self.use_pallas_favor))
        if self.local_heads > 0:
            local = local_attention_flash if self.use_pallas_local else local_attention
            outs.append(local(q[:, gh:], k[:, gh:], v[:, gh:], window=self.local_window,
                              causal=self.causal, compute_dtype=cd))
        out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self.drop(_linear(out, self.to_out, self.dtype))


class FeedForward(nn.Module):
    def __init__(self, dim, mult, gen, device, *, dropout=0.0, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.w1 = _dense(dim, dim * mult, True, gen, device)
        self.w2 = _dense(dim * mult, dim, True, gen, device)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_linear(x, self.w1, self.dtype), approximate="tanh")
        return _linear(self.drop(h), self.w2, self.dtype)


class PerformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, local_heads, nb_features, ff_mult,
                 use_rezero, gen, device, *, ff_dropout=0.0, dtype=torch.bfloat16,
                 **attn_kw):
        super().__init__()
        self.use_rezero, self.dtype = use_rezero, dtype
        self.attn = PerformerAttention(
            dim, heads, dim_head, local_heads, nb_features, gen, device, dtype=dtype,
            **attn_kw,
        )
        self.ff = FeedForward(dim, ff_mult, gen, device, dropout=ff_dropout, dtype=dtype)
        if use_rezero:
            # ReZero gains start at zero (identity blocks), as in the
            # reference; shape (1,) and f32, so that they promote
            self.g_attn = nn.Parameter(torch.zeros(1, device=device))
            self.g_ff = nn.Parameter(torch.zeros(1, device=device))
        else:
            self.norm_attn = nn.LayerNorm(dim, eps=1e-6, device=device)
            self.norm_ff = nn.LayerNorm(dim, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_rezero:
            x = x + self.attn(x) * self.g_attn
            return x + self.ff(x) * self.g_ff
        x = x + self.attn(_layer_norm(x, self.norm_attn, self.dtype))
        return x + self.ff(_layer_norm(x, self.norm_ff, self.dtype))


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
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        waiting = {"rotary_position_emb": rotary_position_emb,
                   "fixed_position_emb": fixed_position_emb,
                   "axial_position_emb": axial_position_emb,
                   "use_scalenorm": use_scalenorm, "ff_glu": ff_glu,
                   "reversible": reversible, "remat_attention": remat_attention}
        for name, on in waiting.items():
            if on:
                raise NotImplementedError(f"{name}=True is {_WAITS}")
        if spatial_position_emb not in (None, "absolute"):
            raise NotImplementedError(
                f"spatial_position_emb={spatial_position_emb!r}: only the learned "
                f"('absolute') tables are ported; 'fixed' is {_WAITS}"
            )
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
        self.dtype = dtype
        gen = generator

        n_pre = (len(self.conditioning_num_tokens)
                 if conditioning_type == "prepending" else 0)
        self.token_emb = _embed(num_tokens, dim, gen, device)
        self.abs_pos_emb = _embed(max_seq_len + n_pre, dim, gen, device)
        self._spatial_sequences = []
        if spatial_position_emb is not None:
            self._spatial_sequences = spatial_coordinate_sequences(spatial_shape, ordering)
            self.spatial_embs = nn.ModuleList(
                [_embed(len(s), dim, gen, device) for s in self._spatial_sequences]
            )
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
        )
        self.blocks = nn.ModuleList([
            PerformerBlock(dim, heads, dim_head, local_attn_heads, self.nb_features,
                           ff_mult, use_rezero, gen, device, ff_dropout=ff_dropout,
                           dtype=dtype, **attn_kw)
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
        spatial coordinate rows (zero row at position 0).  Rows are the
        bf16 lookups of the JAX model, the spatial axes summed in bf16."""
        pos = _bf16(self.abs_pos_emb.weight[:n]).float()
        if self.spatial_position_emb is None:
            return pos
        total = None
        dev = pos.device
        for emb, seq in zip(self.spatial_embs, self._spatial_sequences):
            rows = _bf16(emb.weight[torch.as_tensor(seq[:-1], device=dev)])[: n - 1]
            pad = torch.zeros(n - rows.shape[0], self.dim, dtype=rows.dtype, device=dev)
            rows = torch.cat([pad[:1], rows, pad[1:]], dim=0)  # BOS shift, pad to n
            total = rows if total is None else total + rows
        return pos + total.float()

    # -- full-sequence forward ----------------------------------------------

    def _spatial_pos_sum(self, n: int) -> Optional[torch.Tensor]:
        """(1, n, dim) Σ per-axis coordinate embeddings in ``dtype``,
        right-shifted for BOS: position 0 gets zeros, position p ≥ 1 the
        coordinates of grid cell p − 1, positions past the grid zeros."""
        if self.spatial_position_emb is None:
            return None
        total = None
        dev = self.token_emb.weight.device
        for emb, seq in zip(self.spatial_embs, self._spatial_sequences):
            rows = _lookup(emb, torch.as_tensor(seq[:-1], device=dev), self.dtype)[: n - 1]
            rows = F.pad(rows, (0, 0, 1, n - 1 - rows.shape[0]))
            total = rows if total is None else total + rows
        return total[None]

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
        if x.shape[1] > self.max_seq_len:
            raise ValueError(f"sequence length {x.shape[1]} must be ≤ max_seq_len "
                             f"{self.max_seq_len}")
        h = self._embed_prefix(x, conditionings)
        n = h.shape[1]
        pos = _lookup(self.abs_pos_emb, torch.arange(n, device=h.device), self.dtype)
        h = self.emb_drop(h + pos[None].to(h.dtype))
        for blk in self.blocks:
            h = blk(h)
        h = _layer_norm(h, self.final_norm, self.dtype)
        if conditionings is not None and self.conditioning_type == "prepending":
            h = h[:, len(self.conditioning_embs):]
        if return_encodings:
            return h
        if self.tie_embed:
            return h @ self.token_emb.weight.T.to(h.dtype)
        return _linear(h, self.to_out, self.dtype)


@torch.no_grad()
def redraw_projections(model: Performer, generator: torch.Generator) -> None:
    """Redraw every layer's FAVOR+ projection buffer in place from
    ``generator`` (a CPU generator: the QR factorisations run on the
    host) — the port of ``redraw_projections`` (performer.py:845)."""
    for blk in model.blocks:
        proj = getattr(blk.attn, "projection", None)
        if proj is not None:
            proj.copy_(gaussian_orthogonal_random_matrix(
                proj.shape[0], proj.shape[1], generator=generator))
