"""The host-side plan of the nearest-codeword kernels (``csrc/vq_plan.h``:
rows 3 and 4, ``nearest_codeword`` and ``nearest_codeword_stats``), held
on the CPU: the route and padded width, the code tile and each launch's
shared memory, the grid and its clusters, the split of the codebook over
a cluster, the split rows' bank layout, and the statistics pass's
blocks.  Then a numpy model of the kernel's split-TF32 distance products,
held against JAX's ``nearest_codeword_pallas`` in interpret mode: the
split is accurate enough to keep the indices before the card runs it.

The header is plain C++, compiled into the kernels by nvcc; here the same
header is compiled by the host's C++ compiler into a small library and
called through ctypes.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from synthanatomy_tpu.ops import vq as jvq
from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK
from synthanatomy_tpu_torch.ops import vq

CSRC = Path(vq.__file__).resolve().parent.parent / "csrc"

SHIM = """
#include "vq_plan.h"
extern "C" {
int rows() { return vqp::kRows; }
int threads() { return vqp::kThreads; }
int max_d() { return vqp::kMaxD; }
int max_cluster() { return vqp::kMaxCluster; }
int stat_codes() { return vqp::kStatCodes; }
int idx_chunk() { return vqp::kIdxChunk; }
int stat_list() { return vqp::kStatList; }
int stat_batch() { return vqp::kStatBatch; }
int stat_smem() { return vqp::kStatSmem; }
int width_ok(int d) { return vqp::width_ok(d); }
int padded_d(int d) { return vqp::padded_d(d); }
int k_steps(int d) { return vqp::k_steps(d); }
int reg_steps(int d) { return vqp::reg_steps(d); }
int raw_row_floats(int d) { return vqp::raw_row_floats(d); }
int raw_row_bytes(int d) { return vqp::raw_row_bytes(d); }
int split_tile_bytes(int d, int ct) { return vqp::split_tile_bytes(d, ct); }
int split_offset(int ct, int r, int ks, int h) { return vqp::split_offset(ct, r, ks, h); }
int code_tile(int d) { return vqp::code_tile(d); }
int argmin_smem(int d) { return vqp::argmin_smem(d); }
int split_items(int d) { return vqp::split_items(d); }
int row_tiles(int n) { return vqp::row_tiles(n); }
int splits(int n, int k) { return vqp::splits(n, k); }
int split_codes(int n, int k) { return vqp::split_codes(n, k); }
int split_begin(int n, int k, int s) { return vqp::split_begin(n, k, s); }
int split_end(int n, int k, int s) { return vqp::split_end(n, k, s); }
int argmin_blocks(int n, int k) { return vqp::argmin_blocks(n, k); }
int merge_rows(int n, int k, int r) { return vqp::merge_rows(n, k, r); }
int merge_row(int n, int k, int r, int j) { return vqp::merge_row(n, k, r, j); }
int k_column(int ks, int j) { return vqp::k_column(ks, j); }
int stat_blocks(int k) { return vqp::stat_blocks(k); }
int idx_chunks(int n) { return vqp::idx_chunks(n); }
}
"""

PAPER = (4200, 2048, 32)  # N = B3 x 10x14x10 latents, K 2048, D 32
# the GPU tests' VQ_SHAPES (tests/test_torch_kernels_gpu.py) and wider,
# narrower and larger ones
VQ_SHAPES = [(37, 130, 5), (1000, 300, 64), (4099, 2047, 32), (4200, 2048, 32)]
MORE = [(1, 1, 1), (1, 2048, 32), (128, 8, 8), (129, 9, 17), (300, 100, 65), (130, 64, 256),
        (17000, 2048, 32), (100000, 512, 64), (5000, 16384, 24), (64, 5000, 200)]
WIDTHS = [1, 5, 8, 9, 16, 17, 24, 32, 33, 48, 64, 65, 100, 128, 129, 192, 200, 256]


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/vq_plan.h"
    out = tmp_path_factory.mktemp("vq_plan")
    (out / "shim.cpp").write_text(SHIM)
    lib = out / "libvq_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(out / "shim.cpp"), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    assert so.rows() == 128 and so.threads() == 256 and so.max_d() == 256
    return so


def test_paper_shape_fills_the_card_once(plan):
    """At N 4200, K 2048, D 32: 33 row tiles of 128, each split over a
    cluster of 4 blocks of 512 codes, 132 blocks (the H100's SMs), each
    staging its quarter of the codebook once, in 8 code tiles of 64 (the
    products' N); x's 4 k-steps in registers; a block's shared memory
    leaves room for a second on the SM, so the 33 clusters fit at once."""
    n, k, d = PAPER
    assert plan.row_tiles(n) == 33 and plan.splits(n, k) == 4
    assert plan.split_codes(n, k) == 512 and plan.argmin_blocks(n, k) == 132
    assert plan.reg_steps(d) == 4 and plan.padded_d(d) == 32
    assert plan.code_tile(d) == 64 and plan.argmin_smem(d) == 52736
    assert 2 * (plan.argmin_smem(d) + 1024) <= 233472
    # the codebook bytes the blocks stage: each split once per row tile
    staged = plan.row_tiles(n) * k * d * 4
    assert staged == 33 * 2048 * 32 * 4  # 8.65 MB, against 263 x 256 KB before


@pytest.mark.parametrize("n,k,d", VQ_SHAPES + MORE)
def test_every_row_once_every_code_once_per_row_tile(plan, n, k, d):
    """The grid's blocks (split s = b % S, row tile b / S) cover every row
    once in the cluster's merge (rank r writes rows r, r + S, ... of the
    tile) and every codeword once per row tile: the splits are disjoint,
    non-empty, in code order, of whole n8 tiles but the last, and their
    code tiles cover each split; a cluster holds at most 8 blocks."""
    s_n, tiles = plan.splits(n, k), plan.row_tiles(n)
    assert 1 <= s_n <= plan.max_cluster() and plan.argmin_blocks(n, k) == s_n * tiles
    assert tiles * 128 >= n > (tiles - 1) * 128
    ct = plan.code_tile(d)
    seen = np.zeros(k, np.int32)
    for s in range(s_n):
        c0, c1 = plan.split_begin(n, k, s), plan.split_end(n, k, s)
        assert 0 <= c0 < c1 <= k and c0 % 8 == 0
        assert c1 - c0 == plan.split_codes(n, k) or s == s_n - 1
        for c in range(-(-(c1 - c0) // ct)):  # code tiles: a tile's codes past c1 never win
            lo = c0 + c * ct
            seen[lo:min(c1, lo + ct)] += 1
    assert (seen == 1).all()
    written = np.zeros(tiles * 128, np.int32)
    for b in range(plan.argmin_blocks(n, k)):
        r, tile = b % s_n, b // s_n
        rows = [plan.merge_row(n, k, r, j) for j in range(plan.merge_rows(n, k, r))]
        assert all(0 <= i < 128 for i in rows) and plan.merge_rows(n, k, r) <= plan.threads()
        written[tile * 128 + np.array(rows)] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("n,k", [(37, 130), (1000, 300), (4200, 2048), (17000, 2048),
                                 (300, 1), (5000, 7)])
def test_splits_fill_the_sms_once_at_most(plan, n, k):
    """Splits as many as fill the 132 SMs once, no more than a cluster of
    8 and no split under 8 codes (but a codebook of fewer)."""
    s_n, tiles = plan.splits(n, k), plan.row_tiles(n)
    assert s_n * tiles <= max(132, tiles)
    assert 1 <= s_n <= min(8, max(1, 132 // tiles), -(-k // 8))
    assert plan.split_codes(n, k) % 8 == 0 and (s_n - 1) * plan.split_codes(n, k) < k


@pytest.mark.parametrize("d", WIDTHS)
def test_route_width_and_shared_memory(plan, d):
    """Rows pad to 32, 64, 128 or 256 (whole swizzle atoms); up to 64 wide
    x's split fragments stay in registers (4 or 8 k-steps: the kernel's
    instantiations); the code tile (the products' N) is 64 or 32, the
    largest whose block's shared memory fits (227 KB)."""
    assert plan.width_ok(d)
    dp, ks = plan.padded_d(d), plan.reg_steps(d)
    assert dp in (32, 64, 128, 256) and dp >= d and (dp == 32 or dp < 2 * d)
    assert plan.k_steps(d) == dp // 8
    assert ks == (dp // 8 if dp <= 64 else 0)
    ct, smem = plan.code_tile(d), plan.argmin_smem(d)
    assert ct in (32, 64) and smem <= SMEM_PER_BLOCK
    assert ct == 64 or 4 * plan.split_tile_bytes(d, 2 * ct) + 2 * 2 * ct * plan.raw_row_bytes(d) \
        + 2 * 2 * ct * 4 + 128 * 8 > SMEM_PER_BLOCK
    assert smem == 4 * plan.split_tile_bytes(d, ct) + 2 * ct * plan.raw_row_bytes(d) + 2 * ct * 4 \
        + 128 * 8
    assert plan.split_tile_bytes(d, ct) % 1024 == 0  # each split tile 1024-byte aligned
    assert plan.raw_row_floats(d) == dp + 4 and plan.raw_row_bytes(d) % 16 == 0


def test_widths_past_the_gate_are_refused(plan):
    assert not plan.width_ok(0) and not plan.width_ok(257)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_split_tiles_in_the_128_byte_swizzle(plan, d):
    """A split tile holds every (code r, k-step ks, chunk h) in its own
    16-byte chunk: in atom column ks / 4, row r, at chunk (2·(ks % 4) + h)
    ^ (r % 8), as wgmma reads a K-major tile in the 128-byte swizzle from a
    descriptor started at the k-step's 32 bytes; the chunks fill the tile."""
    ct = plan.code_tile(d)
    seen = np.zeros(plan.split_tile_bytes(d, ct) // 16, np.int32)
    for r in range(ct):
        for ks in range(plan.k_steps(d)):
            for h in (0, 1):
                off = plan.split_offset(ct, r, ks, h)
                start = (ks // 4) * ct * 128 + r * 128  # the row of its atom column
                assert off % 16 == 0 and start <= off < start + 128
                # the address the hardware forms: descriptor start (ks % 4)·32,
                # logical chunk h of the k-step, XOR of bits 4-6 with 7-9
                logical = (ks // 4) * ct * 128 + r * 128 + (ks % 4) * 32 + 16 * h
                assert off == (logical & ~0x70) | ((((logical >> 4) & 7) ^ ((logical >> 7) & 7)) << 4)
                seen[off // 16] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("d", [1, 5, 32, 33, 64, 65, 128, 129, 256])
def test_split_pass_covers_each_code_and_k_step_once(plan, d):
    """The split pass: an item is (code, k-step), k_steps neighbouring
    threads a code (a power of two dividing the warp: the shuffle tree of
    ‖w‖²), a whole number of items a thread; every (code, k-step) of the
    tile once."""
    kst, ct = plan.k_steps(d), plan.code_tile(d)
    assert kst & (kst - 1) == 0 and kst <= 32
    items = plan.split_items(d)
    assert items == ct * kst and items % plan.threads() == 0
    seen = np.zeros((ct, kst), np.int32)
    for tid in range(plan.threads()):
        for u in range(items // plan.threads()):
            i = tid + plan.threads() * u
            seen[i // kst, i % kst] += 1
            assert (i // kst) == (tid - tid % kst + plan.threads() * u) // kst  # one code a lane group
    assert (seen == 1).all()


@pytest.mark.parametrize("d", WIDTHS)
def test_lane_columns_cover_each_k_step(plan, d):
    """k_column, which both load_x (A) and the split pass (B) use: the 8 k
    slots of a k-step take its 8 columns once, so over the k-steps every
    column of the padded row once; lane t's slots t and t + 4 are the
    neighbouring columns 2t and 2t + 1 (one 8-byte load of x); a split
    tile's first chunk (slots 0-3) holds columns 0, 2, 4, 6, the second
    1, 3, 5, 7."""
    cols = [plan.k_column(ks, j) for ks in range(plan.k_steps(d)) for j in range(8)]
    assert sorted(cols) == list(range(plan.padded_d(d)))
    for ks in range(plan.k_steps(d)):
        assert sorted(plan.k_column(ks, j) for j in range(8)) == list(range(8 * ks, 8 * ks + 8))
        for t in range(4):
            assert plan.k_column(ks, t) == 8 * ks + 2 * t
            assert plan.k_column(ks, t + 4) == plan.k_column(ks, t) + 1
    assert [plan.k_column(0, j) for j in range(8)] == [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.mark.parametrize("n,k", [(4200, 2048), (37, 130), (9000, 17), (20000, 2047)])
def test_stats_blocks_cover_the_codebook(plan, n, k):
    """The statistics pass: a block per 16 codewords (two a warp), the
    indices staged 4096 at a time, row lists of 256 a codeword flushed
    before a group of 32 rows could overflow them, 32 rows a batch (a row
    a lane), each codeword's running Σx in shared memory; its static
    shared memory within 48 KB."""
    assert plan.stat_codes() == 16
    assert (plan.stat_blocks(k) - 1) * 16 < k <= plan.stat_blocks(k) * 16
    chunk = plan.idx_chunk()
    assert (plan.idx_chunks(n) - 1) * chunk < n <= plan.idx_chunks(n) * chunk
    assert plan.stat_batch() == 32 and plan.stat_list() % 32 == 0 and plan.stat_list() >= 64
    assert plan.stat_smem() == 4 * (chunk + 16 * (plan.stat_list() + plan.max_d())) <= 48 * 1024


# ---------------------------------------------------------------------------
# a numpy model of the kernel's split-TF32 distance
# ---------------------------------------------------------------------------


def tf32(v):
    """f32 → TF32 by round to nearest, ties away from zero (cvt.rna.tf32)."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v):
    big = tf32(v)
    return big, tf32(np.float32(v) - big)  # v − big is exact in f32


def model_distances(x, w, passes=3):
    """‖w‖² − 2·x·w as the kernel forms it: k-steps of 8 columns, each
    product exact (TF32 × TF32) and each m16n8k8 step's 8 terms added to
    the f32 accumulator (rounded once a step), small·big, big·small then
    big·big; ‖w‖² by f32 FMAs.  ``passes=1`` is one-pass TF32 (big·big
    only), what the kernel must not be."""
    n, d = x.shape
    dp = -(-d // 8) * 8
    xp = np.zeros((n, dp), np.float32)
    wp = np.zeros((w.shape[0], dp), np.float32)
    xp[:, :d], wp[:, :d] = x, w
    xb, xs = split(xp)
    wb, ws = split(wp)
    terms = [(xs, wb), (xb, ws), (xb, wb)] if passes == 3 else [(xb, wb)]
    acc = np.zeros((n, w.shape[0]), np.float32)
    for ks in range(dp // 8):
        sl = slice(8 * ks, 8 * ks + 8)
        for a, b in terms:
            step = a[:, sl].astype(np.float64) @ b[:, sl].astype(np.float64).T
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    wsq = np.zeros(w.shape[0], np.float32)
    for c in range(d):  # f32 FMAs in column order (the kernel's lanes differ only in order)
        wsq = (wsq.astype(np.float64) + w[:, c].astype(np.float64) ** 2).astype(np.float32)
    return (wsq[None, :] - np.float32(2) * acc).astype(np.float32)


def _exact(x, w):
    xd, wd = x.astype(np.float64), w.astype(np.float64)
    return (wd * wd).sum(1)[None, :] - 2.0 * xd @ wd.T


def _data(n, k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,d", [(300, 64, 8), (77, 130, 32), (513, 300, 5), (200, 96, 64),
                                   (64, 40, 100)])
def test_split_tf32_model_keeps_the_jax_indices(n, k, d):
    """The split-TF32 model's indices equal JAX's Pallas kernel
    (interpret mode, f32 products) except on near-ties: rows where the two
    codes' exact (f64) distances lie within 1e-5 of the distance scale,
    the rule the GPU test holds the kernel to."""
    x, w = _data(n, k, d, n + k + d)
    want = np.asarray(jvq.nearest_codeword_pallas(x, w, interpret=True))
    got = np.argmin(model_distances(x, w), axis=1).astype(np.int32)
    exact = _exact(x, w)
    rows = np.nonzero(got != want)[0]
    gap = np.abs(exact[rows, got[rows]] - exact[rows, want[rows]])
    assert (gap <= 1e-5 * np.abs(exact).max()).all(), (rows, gap)


@pytest.mark.parametrize("d", [5, 32, 64, 200])
def test_split_tf32_error_is_far_below_the_tie_margin(d):
    """The model's distance error against f64 stays within 2^-19 of
    Σ|x_d·w_d| (the terms' scale) and far inside the 1e-5 near-tie margin,
    where one-pass TF32 misses by ~1000x more: the split, not luck of the
    data, keeps the order of codes whose distances differ by the margin."""
    x, w = _data(96, 80, d, d)
    exact = _exact(x, w)
    scale = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64).T
    err3 = np.abs(model_distances(x, w) - exact)
    err1 = np.abs(model_distances(x, w, passes=1) - exact)
    margin = 1e-5 * np.abs(exact).max()
    assert (err3 <= 2.0 ** -19 * (scale + np.abs(exact))).all()
    assert err3.max() < margin / 10
    assert err1.max() > 100 * err3.max() and err1.max() > margin


def test_tf32_rounding_matches_the_cvt_rule():
    """tf32(): 10 explicit mantissa bits, round to nearest with ties away
    from zero, as cvt.rna.tf32.f32; the remainder's split is exact."""
    one_ulp = np.float32(2.0 ** -10)
    assert tf32(np.float32(1.0) + one_ulp / 2) == np.float32(1.0) + one_ulp  # tie: away
    assert tf32(-(np.float32(1.0) + one_ulp / 2)) == -(np.float32(1.0) + one_ulp)
    assert tf32(np.float32(1.0) + one_ulp / 4) == np.float32(1.0)
    v = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    big, small = split(v)
    assert (tf32(big) == big).all() and (tf32(small) == small).all()
    assert (np.abs(v.astype(np.float64) - big - small) <= 2.0 ** -21 * np.abs(v)).all()
