"""The Performer prior counted from its configuration's shapes: the
model operations of a train step, and the bytes and operations of one
token of fused decoding.

Configuration keys are the stage-2 CLI's (``vocab_size``, ``n_embd``,
``n_layers``, ``n_head``, ``dim_head``, ``local_attn_heads``,
``local_window_size``, ``nb_features``, ``ff_mult``, ``latent_shape``).
"""

from __future__ import annotations

import math

from benchmark.counts.attention import favor_forward, local_forward


def _dims(cfg: dict):
    d, h, dh = cfg["n_embd"], cfg["n_head"], cfg["dim_head"]
    lh = cfg["local_attn_heads"]
    return d, h, dh, lh, h - lh, cfg["nb_features"], d * cfg["ff_mult"], cfg["vocab_size"] + 1


def seq_len(cfg: dict) -> int:
    """Tokens a grid holds (the trained sequence: BOS and all but the last)."""
    return math.prod(cfg["latent_shape"])


def layer_weights(cfg: dict) -> int:
    """Weights of one block's products: q, k, v, out and the FF's two."""
    d, h, dh, _, _, _, ff, _ = _dims(cfg)
    return 3 * d * h * dh + h * dh * d + 2 * d * ff


def train_step_flops(cfg: dict, batch: int, n: int) -> float:
    """Model operations of one train step, forward and backward, without
    any recompute: every product's forward and its two backward
    products (three times the forward), attention as its mathematics
    (``attention.py``), the head included."""
    d, h, dh, lh, gh, m, ff, v = _dims(cfg)
    rows = batch * n
    fwd = cfg["n_layers"] * 2 * rows * layer_weights(cfg) + 2 * rows * d * v
    if gh:
        fwd += cfg["n_layers"] * favor_forward(batch, gh, n, dh, m)[0]
    if lh:
        fwd += cfg["n_layers"] * local_forward(batch, lh, n, dh, cfg["local_window_size"])[0]
    return 3.0 * fwd


def decode_ring_slots(cfg: dict, t: int) -> int:
    """Ring slots the local heads read at token t: the window's earlier
    keys, max(0, t − w + 1) .. t − 1 (the token's own key is computed)."""
    return min(t, cfg["local_window_size"] - 1)


def fused_step(cfg: dict, batch: int, t: int, weight_bits: int = 8, ring_bits: int = 8):
    """(flops, bytes) of the whole-depth fused decode step at token t:
    the block weights at ``weight_bits`` with f32 per-column scales, the
    FF biases, the projections, the FAVOR state (S bf16, z f32) read and
    written, the ring slots in the window at ``ring_bits`` with f32
    scales, the token's stream read and written and its keys and values
    written for the ring."""
    d, h, dh, lh, gh, m, ff, _ = _dims(cfg)
    L, B = cfg["n_layers"], batch
    cols = 3 * h * dh + d + ff + d
    groups = 2 if weight_bits == 4 else 1
    per_layer = (layer_weights(cfg) * weight_bits // 8 + 4 * groups * cols + 4 * (ff + d)
                 + 4 * dh * m
                 + 2 * (2 * m * B * gh * dh) + 2 * (4 * B * gh * m))
    slots = decode_ring_slots(cfg, t)
    ring = 2 * slots * (B * lh * dh * ring_bits // 8 + (4 * B * lh if ring_bits < 16 else 0))
    nbytes = L * (per_layer + ring) + 2 * 4 * B * d + L * 2 * 4 * B * lh * dh
    flops = L * (2 * B * layer_weights(cfg)
                 + B * gh * (2 * 2 * dh * m + 2 * m * dh + 2 * m * dh + 2 * 2 * m)
                 + B * lh * 2 * 2 * dh * (slots + 1))
    return flops, nbytes


def decode_token(cfg: dict, batch: int, t: int, weight_bits: int = 8, ring_bits: int = 8):
    """(flops, bytes) of one whole token of sampling: the fused step, its
    ring write, the token's embedding and positional rows, the final
    norm and the head (bf16 weights)."""
    d, _, dh, lh, _, _, _, v = _dims(cfg)
    f, nb = fused_step(cfg, batch, t, weight_bits, ring_bits)
    L, B = cfg["n_layers"], batch
    ring_write = 2 * L * (B * lh * dh * ring_bits // 8 + 4 * B * lh)
    head = 2 * d * v + 4 * v + 4 * B * v
    return f + 2 * B * d * v, nb + ring_write + 2 * B * d * 2 + head
