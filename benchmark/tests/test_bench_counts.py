"""The counts from shapes against hand counts and against PyTorch's own
operation counter at tiny shapes."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import attention, conv, peaks, prior
from benchmark.reference import vqvae as ref_vqvae
from benchmark.tests.tiny import TINY_PRIOR, TINY_VQVAE


@pytest.mark.parametrize("n,w", [(1, 4), (5, 3), (7, 7), (12, 5), (1400, 420)])
def test_window_pairs_counts_the_causal_band(n, w):
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    assert attention.window_pairs(n, w) == int(((j <= i) & (j > i - w)).sum())


def test_favor_forward_by_hand():
    b, h, n, d, m = 2, 3, 5, 4, 8
    per_row = 2 * d * m * 2 + 2 * m * d + 2 * m * d + 4 * m
    flops, nbytes = attention.favor_forward(b, h, n, d, m, elem=2)
    assert flops == b * h * n * per_row == 30 * 288
    assert nbytes == 2 * b * h * n * d * 4 + 4 * m * d
    bflops, bbytes = attention.favor_backward(b, h, n, d, m, elem=2)
    assert bflops == 2 * flops and bbytes == 2 * b * h * n * d * 7 + 4 * m * d


def test_local_forward_by_hand():
    # n 4, w 2: pairs 1 + 2 + 2 + 2 = 7, each 2 products of 2d operations
    flops, nbytes = attention.local_forward(1, 1, 4, 8, 2, elem=4)
    assert flops == 7 * 2 * 2 * 8
    assert nbytes == 4 * 4 * 8 * 4


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (1, 1, 0)])
def test_conv3d_matches_the_flop_counter(k, stride, pad):
    x = torch.randn(2, 3, 5, 6, 4)
    w = torch.randn(4, 3, k, k, k)
    with FlopCounterMode(display=False) as fc:
        y = F.conv3d(x, w, stride=stride, padding=pad)
    flops, _ = conv.conv3d(2, 3, 4, k, y[0, 0].numel(), x[0, 0].numel())
    assert flops == fc.get_total_flops()


def test_vqvae_decode_matches_the_flop_counter():
    cfg = dict(TINY_VQVAE)
    shapes = {"vq.codebook": (31, 4), "decoder_in_conv.weight": (8, 4, 3, 3, 3),
              "decoder_in_conv.bias": (8,),
              "decoder_res.0.0.conv1.weight": (8, 8, 3, 3, 3), "decoder_res.0.0.conv1.bias": (8,),
              "decoder_res.0.0.conv2.weight": (8, 8, 1, 1, 1), "decoder_res.0.0.conv2.bias": (8,),
              "decoder_res.1.0.conv1.weight": (4, 4, 3, 3, 3), "decoder_res.1.0.conv1.bias": (4,),
              "decoder_res.1.0.conv2.weight": (4, 4, 1, 1, 1), "decoder_res.1.0.conv2.bias": (4,),
              "decoder_ups.0.weight": (8, 4, 4, 4, 4), "decoder_ups.0.bias": (4,),
              "decoder_ups.1.weight": (4, 1, 4, 4, 4), "decoder_ups.1.bias": (1,)}
    p = {k: torch.randn(s) for k, s in shapes.items()}
    idx = torch.randint(0, 31, (2, 2, 3, 4))
    with FlopCounterMode(display=False) as fc:
        out = ref_vqvae.decode(p, cfg, idx)
    assert tuple(out.shape) == (2, 1, 8, 12, 16)
    assert conv.vqvae_decode(cfg, (2, 3, 4), 2)[0] == fc.get_total_flops()


def test_residual_layer_by_hand():
    flops, nbytes = conv.residual_layer(2, 8, 4, 10)
    assert flops == 2 * 2 * 10 * (8 * 4 * 27 + 4 * 8)
    assert nbytes == 2 * (2 * 2 * 8 * 10 + 8 * 4 * 28)


def test_prior_dense_flops_match_the_flop_counter():
    """The products of a train step's forward (without attention) are
    what the flop counter sees of the same matmuls; backward doubles."""
    cfg = dict(TINY_PRIOR, ff_mult=4)
    b, n = 2, 24
    d, inner, ff, v = 128, 128, 512, 32
    x = torch.randn(b, n, d)
    with FlopCounterMode(display=False) as fc:
        for w in (torch.randn(3 * inner, d), torch.randn(d, inner), torch.randn(ff, d),
                  torch.randn(d, ff)):
            x2 = x if w.shape[1] == d else torch.randn(b, n, w.shape[1])
            x2 @ w.T
        x @ torch.randn(v, d).T
    dense = fc.get_total_flops()
    attn = (attention.favor_forward(b, 1, n, 64, 128)[0]
            + attention.local_forward(b, 1, n, 64, 6)[0])
    assert prior.train_step_flops(cfg, b, n) == 3 * (dense + attn)


def test_fused_step_bytes_by_hand():
    cfg = dict(TINY_PRIOR, ff_mult=4)
    b, t = 2, 3
    flops, nbytes = prior.fused_step(cfg, b, t)
    weights = prior.layer_weights(cfg)
    assert weights == 3 * 128 * 128 + 128 * 128 + 2 * 128 * 512
    cols = 3 * 128 + 128 + 512 + 128
    favor = 2 * (2 * 128 * b * 1 * 64) + 2 * (4 * b * 1 * 128)
    ring = 2 * min(t, 5) * (b * 64 + 4 * b)
    expect = (weights + 4 * cols + 4 * (512 + 128) + 4 * 64 * 128 + favor + ring
              + 2 * 4 * b * 128 + 2 * 4 * b * 64)
    assert nbytes == expect
    assert flops > 2 * b * weights


def test_bounds_take_the_larger_side():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 3.35e12, peak=1.0) == pytest.approx(1.0)
    assert math.isclose(peaks.bound_s(2 * 989e12, 3.35e12), 2.0)
