"""The host-side plan of the launch-overhead tile program
(``csrc/overhead_plan.h``: row 9c, ``probes.tile_steps``), held on the
CPU: the split of K over a cluster, the products a block runs each step,
the grid, the shared memory and its 128-byte swizzle, and which rank
writes which columns.  Then a numpy model of the kernel's order of sums
(each split's k16 products over every step into its own f32 sums, then
the splits added in rank order and rounded once), held against the plain
twin and against JAX's ``jnp.dot`` steps.

The header is plain C++, compiled into the kernel by nvcc; here the same
header is compiled by the host's C++ compiler into a small library and
called through ctypes, with a table standing for the card's answer to
how many clusters fit at once.  The kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu_torch.ops import probes

CSRC = Path(probes.__file__).resolve().parent.parent / "csrc"

SHIM = """
#include "overhead_plan.h"
static int table[ovp::kMaxCluster + 1][ovp::kMaxProducts + 1];
extern "C" {
void set_fit(int s, int p, int n) { table[s][p] = n; }
int fit(int s, int p) { return table[s][p]; }
int max_k() { return ovp::kMaxK; }
int max_products() { return ovp::kMaxProducts; }
int one_block_smem() { return ovp::kOneBlockSmem; }
int shape_ok(int m, int k, int n) { return ovp::shape_ok(m, k, n); }
int tiles(int m, int n) { return ovp::tiles(m, n); }
int min_splits(int k) { return ovp::min_splits(k); }
int splits(int m, int k, int n) {
  return ovp::splits(m, k, n, [](int s, int p) { return table[s][p]; });
}
int split_products(int k, int s) { return ovp::split_products(k, s); }
int split_k0(int k, int s, int r) { return ovp::split_k0(k, s, r); }
int blocks(int m, int n, int s) { return ovp::blocks(m, n, s); }
int x_tile_bytes(int p) { return ovp::x_tile_bytes(p); }
int w_tile_bytes(int p) { return ovp::w_tile_bytes(p); }
int needed_smem(int p, int s) { return ovp::needed_smem(p, s); }
int sums_bytes(int s) { return ovp::sums_bytes(s); }
int sums_offset(int s, int q, int u, int row) { return ovp::sums_offset(s, q, u, row); }
int owned(int s, int r) { return ovp::owned(s, r); }
int x_offset(int r, int k) { return ovp::x_offset(r, k); }
int w_offset(int k, int c) { return ovp::w_offset(k, c); }
int w_product_offset(int p) { return ovp::w_product_offset(p); }
int group(int s, int r, int u) { return ovp::group(s, r, u); }
}
"""

PROBE = (256, 512, 512)  # the probe's M, K, N
# the GPU tests' shapes and more: K 48 and 16 (one product a split), K
# 1024, K 2048 (the most), K not a multiple of the split, K 0
SHAPES = [PROBE, (64, 48, 128), (128, 1024, 256), (64, 16, 64), (64, 176, 64),
          (4096, 512, 4096), (64, 0, 64), (192, 112, 320), (64, 1008, 128), (64, 2048, 64)]
AMPLE = 1000  # clusters that fit: more than any grid here holds
H100_FIT_4 = 30  # clusters of 4 the H100 holds at one block an SM (cudaOccupancyMaxActiveClusters)


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/overhead_plan.h"
    out = tmp_path_factory.mktemp("overhead_plan")
    (out / "shim.cpp").write_text(SHIM)
    lib = out / "liboverhead_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(out / "shim.cpp"), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    assert so.max_k() == 2048 and so.max_products() == 16
    return so


@pytest.fixture
def card(plan):
    """A card on which every cluster size fits AMPLE times at once; a test
    may shrink it."""
    for s in range(1, 9):
        for p in range(1, 17):
            plan.set_fit(s, p, AMPLE)
    return plan


def test_probe_shape_fills_the_card_once(card):
    """At 256 × 512 × 512: 32 tiles of 64 × 64.  On a card that held every
    cluster, K would split over clusters of 4 (8 k16 products of 128 a
    split, 128 blocks on 132 SMs); the H100 holds only 30 clusters of 4 at
    one block an SM, so the plan takes 3 splits of 11 products (the last
    one of zeros): 96 blocks, all resident."""
    m, k, n = PROBE
    assert card.tiles(m, n) == 32 and card.min_splits(k) == 2
    s = card.splits(m, k, n)
    assert s == 4 and card.split_products(k, s) == 8 and card.blocks(m, n, s) == 128
    for p in range(1, 17):
        card.set_fit(4, p, H100_FIT_4)
    s = card.splits(m, k, n)
    assert s == 3 and card.split_products(k, s) == 11 and card.blocks(m, n, s) == 96


@pytest.mark.parametrize("k,want", [(48, (3, 1)), (16, (1, 1)), (1024, (8, 8)), (0, (1, 1)),
                                    (176, (6, 2)), (32, (2, 1)), (2048, (8, 16))])
def test_small_and_large_k(card, k, want):
    """K 48 runs three splits of one product each, K 16 one block a tile,
    K 1024 8 splits of 8, K 2048 the most (8 of 16), K 0 one split of
    zeros; K 176 (11 products) six splits of two, the last one product and
    one of zeros."""
    m, n = (64, 128) if k < 1024 else (128, 256)
    s = card.splits(m, k, n)
    assert (s, card.split_products(k, s)) == want


def test_fewer_clusters_fit(card):
    """Where the card holds fewer clusters of a size than the grid has
    (here clusters of more than 4 fit 3 times: 4 tiles need 4), the plan
    takes the largest split that fits; where even the fewest splits the
    registers allow do not fit, it takes those."""
    m, k, n = 64, 512, 256
    assert card.splits(m, k, n) == 8  # 4 tiles × 8 = 32 blocks
    for s in range(5, 9):
        for p in range(1, 17):
            card.set_fit(s, p, 3)
    assert card.splits(m, k, n) == 4 and card.split_products(k, 4) == 8
    for s in range(1, 9):
        for p in range(1, 17):
            card.set_fit(s, p, 1)
    assert card.splits(m, k, n) == 2 and card.split_products(k, 2) == 16  # the floor


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_splits_cover_every_product_once(card, m, k, n):
    """The splits of a tile are one cluster of at most 8, none empty, each
    at most 16 k16 products (x's fragments in registers), together every
    product of K once in order; as many as fill the 132 SMs once, or the
    fewest the registers allow."""
    assert card.shape_ok(m, k, n)
    s = card.splits(m, k, n)
    p = card.split_products(k, s)
    prods = k // 16
    assert 1 <= s <= 8 and 1 <= p <= 16 and s >= card.min_splits(k)
    seen = np.zeros(max(prods, 1), np.int32)
    for r in range(s):
        k0 = card.split_k0(k, s, r)
        assert k0 % 16 == 0 and k0 == r * p * 16
        mine = [q for q in range(k0 // 16, k0 // 16 + p) if q < prods]
        assert mine or prods == 0, f"split {r} of {s} is empty"
        seen[mine] += 1
    assert (seen[:prods] == 1).all()
    t = card.tiles(m, n)
    assert t * s <= 132 or s == card.min_splits(k)


@pytest.mark.parametrize("m,k,n", [(60, 32, 64), (64, 40, 64), (64, 32, 96), (64, 2064, 64),
                                   (0, 16, 64), (64, -16, 64)])
def test_shapes_the_kernel_refuses(card, m, k, n):
    assert not card.shape_ok(m, k, n)


@pytest.mark.parametrize("p", range(1, 17))
def test_shared_memory_and_atoms(card, p):
    """x's slice is whole 64-k atom columns (8 KB each), w's slice 2 KB a
    product, both on 1024-byte atoms; with the owner's sums of every
    cluster size they fit the 116 KB a block asks for, which leaves no
    room for a second block on the SM (228 KB, 1 KB reserved a block)."""
    xb, wb = card.x_tile_bytes(p), card.w_tile_bytes(p)
    assert xb == -(-p // 4) * 8192 and wb == p * 2048
    assert xb % 1024 == 0 and wb % 1024 == 0
    one = card.one_block_smem()
    assert one + 1024 <= 233472 < 2 * (one + 1024)
    for s in range(1, 9):
        assert card.needed_smem(p, s) == xb + wb + card.sums_bytes(s) <= one
    for q in range(p):
        assert card.w_product_offset(q) == q * 2048  # a descriptor's start: 16 rows of 128 B


@pytest.mark.parametrize("s", range(1, 9))
def test_owner_buffers_hold_every_rank_once(card, s):
    """An owner's buffer holds, for each rank q and each owned group u
    (rank r owns groups r, r + S, ...), 64 rows of 8 f32 (32 bytes), each
    in its own place, inside sums_bytes(S); the rows a warp pushes (8 rows
    × 32 bytes) are contiguous."""
    for r in range(s):
        assert card.owned(s, r) == len([j for j in range(8) if j % s == r])
    seen = set()
    for q in range(s):
        for u in range(card.owned(s, 0)):
            for row in range(64):
                off = card.sums_offset(s, q, u, row)
                assert off % 32 == 0 and 0 <= off <= card.sums_bytes(s) - 32
                seen.add(off)
            base = card.sums_offset(s, q, u, 0)
            assert [card.sums_offset(s, q, u, i) - base for i in range(8)] == list(range(0, 256, 32))
    assert len(seen) == s * card.owned(s, 0) * 64


def _swizzled(logical):
    """The address the hardware forms in the 128-byte swizzle: bits 4-6
    XOR bits 7-9."""
    return (logical & ~0x70) | ((((logical >> 4) & 7) ^ ((logical >> 7) & 7)) << 4)


@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_x_slice_in_the_128_byte_swizzle(card, p):
    """x's (row r, 8 k from k) in its own 16-byte chunk, where wgmma's
    K-major 128-byte swizzle puts it (atom column k / 64, row r of 128
    bytes); the chunks fill the slice; the 8 rows an ldmatrix phase reads
    at one k fall on 8 different 16-byte bank groups."""
    seen = np.zeros(card.x_tile_bytes(p) // 16, np.int32)
    for r in range(64):
        for k in range(0, 16 * p, 8):
            off = card.x_offset(r, k)
            logical = (k // 64) * 64 * 128 + r * 128 + (k % 64) * 2
            assert off == _swizzled(logical)
            seen[off // 16] += 1
    assert seen.max() == 1 and seen.sum() == 64 * 2 * p
    for r0 in range(0, 64, 8):
        for k in range(0, 16 * p, 8):
            assert len({(card.x_offset(r0 + i, k) // 16) % 8 for i in range(8)}) == 8


@pytest.mark.parametrize("p", [1, 2, 8])
def test_w_slice_in_the_128_byte_swizzle(card, p):
    """w's (row k, chunk c of 8 columns) where wgmma's MN-major 128-byte
    swizzle puts it: row k of 128 bytes, 8-row atoms 1024 bytes apart (the
    descriptor's stride); every chunk of the slice once."""
    seen = np.zeros(card.w_tile_bytes(p) // 16, np.int32)
    for k in range(16 * p):
        for c in range(8):
            off = card.w_offset(k, c)
            assert off == _swizzled(k * 128 + c * 16)
            seen[off // 16] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("s", range(1, 9))
def test_each_column_group_written_by_one_rank(card, s):
    """Rank r sums and writes groups r, r + S, ... (its slots u <
    owned(S, r)): each of the tile's 8 column groups by exactly one rank,
    every rank of a cluster of up to 8 at least one; and the push's walk
    (owner j % S, slot j / S, counted up as the kernel does) lands group j
    where its owner reads it."""
    groups = [card.group(s, r, u) for r in range(s) for u in range(card.owned(s, r))]
    assert sorted(groups) == list(range(8))
    assert all(card.owned(s, r) >= 1 for r in range(s))
    owner = slot = 0
    for j in range(8):
        assert card.group(s, owner, slot) == j and slot < card.owned(s, owner)
        owner += 1
        if owner == s:
            owner, slot = 0, slot + 1


# ---------------------------------------------------------------------------
# a numpy model of the kernel's order of sums
# ---------------------------------------------------------------------------


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def model_tile_steps(x, w, steps, s, p):
    """bf16(Σ_r acc_r) in rank order, acc_r split r's f32 sums: every step
    adds its k16 products q = r·p … r·p + p − 1 (past K: zeros) one at a
    time, each product's 16 terms exact and rounded once into the f32
    sums, as a wgmma k16 step into its accumulators."""
    k = x.shape[1]
    xd, wd = x.astype(np.float64), w.astype(np.float64)
    parts = []
    for r in range(s):
        acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
        for _ in range(steps):
            for q in range(r * p, r * p + p):
                if 16 * q < k:
                    sl = slice(16 * q, 16 * q + 16)
                    acc = (acc.astype(np.float64) + xd[:, sl] @ wd[sl]).astype(np.float32)
        parts.append(acc)
    total = np.float32(0) + np.zeros_like(parts[0])
    for acc in parts:
        total = (total + acc).astype(np.float32)
    return _bf16(total)


def _data(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return _bf16(rng.normal(size=(m, k))), _bf16(rng.normal(size=(k, n)))


@pytest.mark.parametrize("m,k,n,steps", [(64, 48, 128, 3), (128, 256, 64, 5), (64, 16, 64, 2),
                                         (64, 176, 64, 4)])
def test_split_order_model_matches_plain_and_jax(card, m, k, n, steps):
    """The model at the plan's split of K equals the plain twin and JAX's
    ``jnp.dot`` steps (bf16 operands, f32 sums, one bf16 rounding) within
    1e-2 of max |plain|, the tolerance the GPU tests hold the kernel to;
    the rank order of the cluster's sum makes it deterministic."""
    s = card.splits(m, k, n)
    p = card.split_products(k, s)
    x, w = _data(m, k, n, m + k + n + steps)
    got = model_tile_steps(x, w, steps, s, p)
    plain = probes.tile_steps_plain(torch.from_numpy(x).to(torch.bfloat16),
                                    torch.from_numpy(w).to(torch.bfloat16), steps).float().numpy()
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    acc = jnp.zeros((m, n), jnp.float32)
    for _ in range(steps):
        acc = acc + jnp.dot(xj, wj, preferred_element_type=jnp.float32)
    jax_out = np.asarray(acc.astype(jnp.bfloat16).astype(jnp.float32))
    tol = 1e-2 * np.abs(plain).max()
    assert np.abs(got - plain).max() <= tol
    assert np.abs(got - jax_out).max() <= tol
    assert np.array_equal(got, model_tile_steps(x, w, steps, s, p))


@pytest.mark.parametrize("kernel", ["launch_overhead", "int4_unpack"])
def test_bench_builds_needs_the_card(kernel):
    """The bench of the probe kernels' builds (rows 9c and 9b) times the
    card only: without one it raises before it builds anything."""
    from synthanatomy_tpu_torch.tools import bench_builds

    if torch.cuda.is_available():
        pytest.skip("the refusal is checked where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_builds.main([kernel, "current"])
