"""The Performer prior of the paper's form in plain float32 PyTorch.

Written from the model's equations, not from the program: embeddings
(token, learned absolute position, the learned spatial-coordinate rows
of the raster grid shifted right for BOS), ReZero blocks of hybrid
attention (the first ``n_head − local_attn_heads`` heads causal FAVOR+
with orthogonal random features, the rest causal softmax attention over
a window with rotary phases) and a GELU (tanh) feed-forward, a final
LayerNorm and the output head.  Parameters are taken by the program's
``state_dict`` names from a dict the benchmark made; nothing of the
program is imported.

``rnd`` rounds every product's operands (the identity: float32; the
controls pass a lower precision).  TF32 must be off while it runs
(:func:`benchmark.reference.precision.exact_f32`).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Rnd = Callable[[torch.Tensor], torch.Tensor]


def _ident(x: torch.Tensor) -> torch.Tensor:
    return x


def check_form(cfg: dict) -> None:
    """The reference covers the paper's form only."""
    want = dict(use_rezero=True, position_emb="absolute", spatial_position_emb="absolute",
                ordering_type="raster_scan", generalized_attention=False, ff_glu=False,
                qkv_bias=False, attn_out_bias=False, tie_embed=False, use_scalenorm=False,
                reversible=False, conditioning_type="none")
    bad = {k: cfg.get(k, v) for k, v in want.items() if cfg.get(k, v) != v}
    if bad:
        raise ValueError(f"the reference prior does not cover {bad}")


def spatial_rows(p: Dict[str, torch.Tensor], grid, n: int) -> torch.Tensor:
    """(n, dim): position 0 (BOS) zeros, position q ≥ 1 the sum of the
    coordinate rows of raster cell q − 1."""
    dev = p["token_emb.weight"].device
    cells = torch.arange(n - 1, device=dev)
    coords = []
    for size in reversed(grid):  # raster: the last axis fastest
        coords.append(cells % size)
        cells = cells // size
    coords = coords[::-1]
    rows = sum(p[f"spatial_embs.{i}.weight"][c] for i, c in enumerate(coords))
    return F.pad(rows, (0, 0, 1, 0))


def favor_causal(q, k, v, proj, rnd: Rnd = _ident, chunk: int = 128):
    """Causal FAVOR+ (softmax kernel, positive features): q, k, v (B, H,
    N, d) → (B, H, N, d).  Query features stabilised by their row
    maximum (it cancels between numerator and denominator but for the
    1e-4 floor), keys by 0."""
    d, m = q.shape[-1], proj.shape[0]
    dn = d ** -0.25
    qd = rnd(q * dn) @ rnd(proj).T
    kd = rnd(k * dn) @ rnd(proj).T
    qp = m ** -0.5 * (torch.exp(qd - (q * q).sum(-1, keepdim=True) * (dn * dn / 2)
                                - qd.amax(-1, keepdim=True)) + 1e-4)
    kp = m ** -0.5 * (torch.exp(kd - (k * k).sum(-1, keepdim=True) * (dn * dn / 2)) + 1e-4)
    b, h, n, _ = q.shape
    S = q.new_zeros(b, h, m, v.shape[-1])
    z = q.new_zeros(b, h, m)
    outs = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc = rnd(qp[:, :, sl]), rnd(kp[:, :, sl]), rnd(v[:, :, sl])
        c = qc.shape[2]
        a = (qc @ kc.transpose(-1, -2)) * torch.tril(q.new_ones(c, c))
        num = rnd(a) @ vc + qc @ rnd(S)
        den = a.sum(-1) + (qc * z[:, :, None]).sum(-1)
        outs.append(num / den.clamp_min(1e-12)[..., None])
        S = S + kc.transpose(-1, -2) @ vc
        z = z + kc.sum(2)
    return torch.cat(outs, dim=2)


def rotary(x: torch.Tensor) -> torch.Tensor:
    """Rotary phases at positions 0..N−1 on (…, N, d), the two halves of
    the head sharing frequencies 10000^(−2i/d)."""
    n, d = x.shape[-2], x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d))
    ang = torch.arange(n, device=x.device, dtype=torch.float32)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    x1, x2 = x.chunk(2, dim=-1)
    return x * torch.cos(ang) + torch.cat([-x2, x1], dim=-1) * torch.sin(ang)


def local_causal(q, k, v, window: int, rnd: Rnd = _ident, block: int = 128):
    """Causal softmax attention over keys i − window < j ≤ i, rotary on q
    and k: (B, H, N, d) → (B, H, N, d), in blocks of query rows."""
    q, k = rotary(q), rotary(k)
    n, d = q.shape[-2], q.shape[-1]
    outs = []
    for i0 in range(0, n, block):
        i1 = min(n, i0 + block)
        j0 = max(0, i0 - window + 1)
        s = (rnd(q[:, :, i0:i1]) @ rnd(k[:, :, j0:i1]).transpose(-1, -2)) * d ** -0.5
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(j0, i1, device=q.device)[None, :]
        s = s.masked_fill(~((kj <= qi) & (kj > qi - window)), float("-inf"))
        outs.append(rnd(torch.softmax(s, dim=-1)) @ rnd(v[:, :, j0:i1]))
    return torch.cat(outs, dim=2)


def _layer_norm(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def logits(p: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
           rnd: Rnd = _ident) -> torch.Tensor:
    """tokens (B, N) (BOS first) → (B, N, vocab + 1) float32 logits."""
    check_form(cfg)
    b, n = tokens.shape
    h_, dh, lh = cfg["n_head"], cfg["dim_head"], cfg["local_attn_heads"]
    gh = h_ - lh
    x = (p["token_emb.weight"][tokens] + spatial_rows(p, cfg["latent_shape"], n)[None]
         + p["abs_pos_emb.weight"][:n][None])

    def lin(t, w, bias=None):
        y = rnd(t) @ rnd(w).T
        return y if bias is None else y + bias

    for i in range(cfg["n_layers"]):
        pre = f"blocks.{i}."
        qkv = [lin(x, p[pre + f"attn.to_{c}.weight"]).reshape(b, n, h_, dh).transpose(1, 2)
               for c in "qkv"]
        q, k, v = qkv
        parts = []
        if gh:
            parts.append(favor_causal(q[:, :gh], k[:, :gh], v[:, :gh],
                                      p[pre + "attn.projection"], rnd))
        if lh:
            parts.append(local_causal(q[:, gh:], k[:, gh:], v[:, gh:],
                                      cfg["local_window_size"], rnd))
        o = torch.cat(parts, dim=1).transpose(1, 2).reshape(b, n, h_ * dh)
        x = x + p[pre + "g_attn"] * lin(o, p[pre + "attn.to_out.weight"])
        f = F.gelu(lin(x, p[pre + "ff.w1.weight"], p[pre + "ff.w1.bias"]), approximate="tanh")
        x = x + p[pre + "g_ff"] * lin(f, p[pre + "ff.w2.weight"], p[pre + "ff.w2.bias"])
    x = _layer_norm(x, p["final_norm.weight"], p["final_norm.bias"])
    return lin(x, p["to_out.weight"], p["to_out.bias"])


def ce_loss(p, cfg, inputs, targets, rnd: Rnd = _ident) -> torch.Tensor:
    """Mean next-token cross-entropy."""
    lg = logits(p, cfg, inputs, rnd)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), targets.reshape(-1))


def int8_folded(p: Dict[str, torch.Tensor], cfg: dict) -> Dict[str, torch.Tensor]:
    """The weights the int8 decode step serves, worked out again: each
    ReZero gain folded into the products its branch ends in (out and w2,
    w2's bias), then every block product quantised to int8 symmetric per
    output channel (max |w| / 127 a channel) and back."""
    out = dict(p)
    for i in range(cfg["n_layers"]):
        pre = f"blocks.{i}."
        g_a, g_f = p[pre + "g_attn"], p[pre + "g_ff"]
        folded = {"attn.to_q.weight": p[pre + "attn.to_q.weight"],
                  "attn.to_k.weight": p[pre + "attn.to_k.weight"],
                  "attn.to_v.weight": p[pre + "attn.to_v.weight"],
                  "attn.to_out.weight": p[pre + "attn.to_out.weight"] * g_a,
                  "ff.w1.weight": p[pre + "ff.w1.weight"],
                  "ff.w2.weight": p[pre + "ff.w2.weight"] * g_f}
        for name, w in folded.items():
            out[pre + name] = quant_dequant(w, bits=8)
        out[pre + "ff.w2.bias"] = p[pre + "ff.w2.bias"] * g_f
        out[pre + "g_attn"] = torch.ones_like(g_a)
        out[pre + "g_ff"] = torch.ones_like(g_f)
    return out


def quant_dequant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """(out, in) weight quantised symmetric per output channel to
    ``bits`` and back."""
    levels = 2 ** (bits - 1) - 1
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / levels
    return torch.clamp(torch.round(w / scale), -levels, levels) * scale


def greedy_gaps(ref_logits: torch.Tensor, served: torch.Tensor, bos: int) -> torch.Tensor:
    """Per position, how far the served token's reference logit lies below
    the reference's best token (BOS never served, so left out)."""
    lg = ref_logits.clone()
    lg[..., bos] = float("-inf")
    best = lg.amax(-1)
    return best - lg.gather(-1, served[..., None])[..., 0]


def tokens_from_grid(grid: torch.Tensor) -> torch.Tensor:
    """(B, *grid) raster grids → (B, N) sequences."""
    return grid.reshape(grid.shape[0], -1).long()


def teacher_inputs(seq: torch.Tensor, bos: int) -> torch.Tensor:
    """BOS, then every token but the last."""
    return torch.cat([torch.full_like(seq[:, :1], bos), seq[:, :-1]], dim=1)
