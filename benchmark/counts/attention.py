"""Causal FAVOR+ and banded causal local attention, counted as their
mathematics from shapes: the same count whatever implements them.

FAVOR+ is counted as the feature maps of q and k (one product with the
(m, d) projection each), the prefix state (one m×d outer product a row),
its read-out (q'·S a row) and the normaliser (z's prefix sum and q'·z).
It is not counted as chunks: a chunked algorithm's diagonal blocks are
its own choice, and a count that depends on the chunk size would move
when an implementation changes it (so ``chip_smoke.py::_favor_flops``,
which counts the chunked algorithm, is not used here).  Exponentials
and other elementwise work are not counted.

Local attention is counted over the causal window's real pairs: query i
sees keys max(0, i − w + 1) .. i, so Σᵢ min(i + 1, w) pairs, not the
padded tiles.  Each pair costs a q·k product and a p·v product.

Bytes: each input read once and each output written once.  Backward
calls read q, k, v and the output's gradient and write dq, dk, dv; their
products are twice the forward's, as for any product.
"""

from __future__ import annotations


def favor_forward(b: int, h: int, n: int, d: int, m: int, elem: int = 2):
    """(flops, bytes) of one causal FAVOR+ forward call over (b, h, n, d)
    with m random features and ``elem``-byte operands."""
    rows = b * h * n
    flops = rows * (2 * 2 * d * m      # q·Pᵀ, k·Pᵀ
                    + 2 * m * d        # k'ᵀ v into the prefix state
                    + 2 * m * d        # q' · S
                    + 2 * 2 * m)       # z's prefix sum, q' · z
    nbytes = elem * rows * d * 4 + 4 * m * d  # q, k, v, out; the f32 projection
    return flops, nbytes


def favor_backward(b, h, n, d, m, elem: int = 2):
    f, _ = favor_forward(b, h, n, d, m, elem)
    return 2 * f, elem * b * h * n * d * 7 + 4 * m * d


def window_pairs(n: int, w: int) -> int:
    """Σ_{i<n} min(i + 1, w): the causal window's (query, key) pairs."""
    full = max(0, n - w)
    head = min(n, w)
    return head * (head + 1) // 2 + full * w


def local_forward(b: int, h: int, n: int, d: int, w: int, elem: int = 2):
    """(flops, bytes) of one banded causal local-attention forward call."""
    flops = b * h * window_pairs(n, w) * 2 * 2 * d  # q·k and p·v a pair
    return flops, elem * b * h * n * d * 4


def local_backward(b, h, n, d, w, elem: int = 2):
    f, _ = local_forward(b, h, n, d, w, elem)
    return 2 * f, elem * b * h * n * d * 7
