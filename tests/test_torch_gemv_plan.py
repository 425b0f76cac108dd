"""The host-side plan of the weight-streaming GEMVs (``csrc/gemv_plan.h``:
rows 2 and 9a, ``int8_matmul``, ``int4_matmul`` and ``weight_stream``),
held on the CPU: grids, splits and clusters, m16 tiles and row groups,
each launch's shared memory, the rings' bank layout, and the weight bytes
a call reads, block by block as the kernels walk them.

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

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK
from synthanatomy_tpu_torch.ops import quant

CSRC = Path(quant.__file__).resolve().parent.parent / "csrc"

SHIM = """
#include "gemv_plan.h"
extern "C" {
int strip() { return gvp::kStrip; }
int k_step() { return gvp::kKStep; }
int chunk() { return gvp::kChunk; }
int max_splits() { return gvp::kMaxSplits; }
int max_tiles() { return gvp::kMaxTiles; }
int group_strips() { return gvp::kGroupStrips; }
int stream_cols() { return gvp::kStreamCols; }
int x_pad() { return gvp::kXPad; }
int ring_row_bytes(int sw) { return gvp::ring_row_bytes(sw); }
int x_row(int rows) { return gvp::x_row(rows); }
int m_tiles(int r) { return gvp::m_tiles(r); }
int row_groups(int r) { return gvp::row_groups(r); }
int strips(int n) { return gvp::strips(n); }
int strip_cols(int n, int x) { return gvp::strip_cols(n, x); }
int split_rows(int kp, int n, int r) { return gvp::split_rows(kp, n, r); }
int splits(int kp, int n, int r) { return gvp::splits(kp, n, r); }
int split_begin(int kp, int n, int r, int y) { return gvp::split_begin(kp, n, r, y); }
int split_count(int kp, int n, int r, int y) { return gvp::split_count(kp, n, r, y); }
int matmul_blocks(int kp, int n, int r) { return gvp::matmul_blocks(kp, n, r); }
int matmul_smem(int kp, int n, int r, int int4) { return gvp::matmul_smem(kp, n, r, int4); }
int stream_groups(int k, int n) { return gvp::stream_groups(k, n); }
int stream_warps(int k, int n) { return gvp::stream_warps(k, n); }
int stream_rounds(int k, int n) { return gvp::stream_rounds(k, n); }
int stream_col_tiles(int k) { return gvp::stream_col_tiles(k); }
int stream_blocks(int l, int b, int k) { return gvp::stream_blocks(l, b, k); }
int stream_group_col0(int k, int c, int g) { return gvp::stream_group_col0(k, c, g); }
int stream_group_cols(int k, int c) { return gvp::stream_group_cols(k, c); }
int stream_smem(int b, int k, int n, int int4) { return gvp::stream_smem(b, k, n, int4); }
long long matmul_weight_reads(int k, int n, int r, int int4) {
  return gvp::matmul_weight_reads(k, n, r, int4);
}
long long stream_weight_reads(int b, int k, int n, int int4) {
  return gvp::stream_weight_reads(b, k, n, int4);
}
}
"""

# the paper decode GEMVs (chip_smoke.py's INT8_GEMV): q/k/v, out, FF in, FF out
PAPER_GEMVS = [(16, 512, 1024), (16, 1024, 512), (16, 512, 2048), (16, 2048, 512)]
# row 9a's probe (B, K, N) and shapes of the GPU tests
STREAMS = [(16, 512, 2048), (1, 512, 2048), (17, 128, 512), (33, 128, 512), (16, 72, 144),
           (16, 40, 200), (64, 512, 2048), (65, 32, 64), (2, 1100, 1100)]
RAGGED = [(1, 200, 96), (5, 64, 1000), (7, 30, 17), (17, 72, 200), (65, 512, 1024),
          (33, 128, 256), (16, 9000, 96), (3, 1100, 64)]


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/gemv_plan.h"
    out = tmp_path_factory.mktemp("gemv_plan")
    (out / "shim.cpp").write_text(SHIM)
    lib = out / "libgemv_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(out / "shim.cpp"), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    so.matmul_weight_reads.restype = so.stream_weight_reads.restype = ctypes.c_longlong
    assert so.strip() == 32 and so.k_step() == 16 and so.chunk() % so.k_step() == 0
    return so


@pytest.mark.parametrize("int4", [0, 1], ids=["int8", "int4"])
def test_paper_gemvs_spread_over_the_sms(plan, int4):
    """At R16 each paper GEMV spreads over at least 132 blocks (the H100's
    SMs), in splits of whole k-steps that cover K, one cluster of at most
    16 a strip."""
    for r, k, n in PAPER_GEMVS:
        kp = k // 2 if int4 else k
        rows, s = plan.split_rows(kp, n, r), plan.splits(kp, n, r)
        assert plan.matmul_blocks(kp, n, r) == plan.strips(n) * s >= 132, (k, n)
        assert rows % 16 == 0 and (s - 1) * rows < kp <= s * rows, (k, n)
        assert 1 <= s <= plan.max_splits() == 16, (k, n)


@pytest.mark.parametrize("r,tiles,groups", [(1, 1, 1), (16, 1, 1), (17, 2, 1), (32, 2, 1),
                                            (33, 4, 1), (64, 4, 1), (65, 4, 2), (200, 4, 4)])
def test_m_tiles_and_row_groups(plan, r, tiles, groups):
    """Up to 64 rows of x ride in one block as one, two or four m16 tiles
    (the kernels' instantiations); beyond, groups of 64 walk the grid."""
    assert plan.m_tiles(r) == tiles and plan.row_groups(r) == groups
    assert 16 * tiles * groups >= r > 16 * tiles * (groups - 1) or groups == 1
    assert tiles <= plan.max_tiles()


def _matmul_coverage(plan, r, k, n, int4):
    """How often each weight byte is read, block by block as matmul_kernel
    walks them (strips of N x splits of K x row groups)."""
    kp = k // 2 if int4 else k
    seen = np.zeros((kp, n), np.int32)
    for _ in range(plan.row_groups(r)):
        for y in range(plan.splits(kp, n, r)):
            k0, cnt = plan.split_begin(kp, n, r, y), plan.split_count(kp, n, r, y)
            assert cnt > 0 and k0 % 16 == 0
            for x in range(plan.strips(n)):
                cols = plan.strip_cols(n, x)
                assert 0 < cols <= 32
                seen[k0:k0 + cnt, 32 * x:32 * x + cols] += 1
    return seen


@pytest.mark.parametrize("int4", [0, 1], ids=["int8", "int4"])
@pytest.mark.parametrize("r,k,n", PAPER_GEMVS + RAGGED)
def test_matmul_reads_each_weight_once(plan, r, k, n, int4):
    """Every byte of W (K x N, or K/2 x N packed) is read by exactly one
    block once for every group of 64 rows of x: once a call up to R 64,
    for all rows at once; ragged K and N are covered exactly, with no
    byte read twice.  The plan's count says the same."""
    seen = _matmul_coverage(plan, r, k, n, int4)
    groups = plan.row_groups(r)
    assert (seen == groups).all()
    kp = k // 2 if int4 else k
    assert plan.matmul_weight_reads(k, n, r, int4) == groups * kp * n
    if r <= 64:
        assert plan.matmul_weight_reads(k, n, r, int4) == kp * n


@pytest.mark.parametrize("int4", [0, 1], ids=["int8", "int4"])
@pytest.mark.parametrize("b,k,n", STREAMS)
def test_stream_reads_each_weight_once(plan, b, k, n, int4):
    """The stream's blocks (128 output columns x every fold group g, a
    layer, a row group) read every byte of a layer's W once for every
    group of 64 rows of x, the group's columns g·K + c0 .. only up to
    column K of group g (the next group's own blocks read the rest)."""
    kp = k // 2 if int4 else k
    seen = np.zeros(n, np.int32)  # every packed row of a strip alike
    for _ in range(plan.row_groups(b)):
        for c in range(plan.stream_col_tiles(k)):
            for g in range(plan.stream_groups(k, n)):
                c0, cols = plan.stream_group_col0(k, c, g), plan.stream_group_cols(k, c)
                assert 0 < cols <= plan.stream_cols() and c0 + cols <= (g + 1) * k
                seen[c0:c0 + cols] += 1
    assert (seen == plan.row_groups(b)).all()
    assert plan.stream_weight_reads(b, k, n, int4) == plan.row_groups(b) * kp * n
    if b <= 64:
        assert plan.stream_weight_reads(b, k, n, int4) == kp * n


@pytest.mark.parametrize("k,n", [(512, 2048), (128, 512), (72, 144), (40, 200), (64, 64),
                                 (32, 96), (100, 500), (1100, 1100)])
def test_stream_rounds_hold_whole_groups(plan, k, n):
    """The warps of a stream block share rings by fold group (four warps
    a group), so a round holds whole groups, the rounds walk every group
    once in g order, and the fold adds them in that order."""
    warps, groups = plan.stream_warps(k, n), plan.stream_groups(k, n)
    gs = plan.group_strips()
    assert gs * plan.strip() == plan.stream_cols() and warps % gs == 0 and warps <= 8
    order = [w // gs + rnd * (warps // gs) for rnd in range(plan.stream_rounds(k, n))
             for w in range(0, warps, gs)]
    assert [g for g in order if g < groups] == list(range(groups))


def test_stream_paper_shape_fills_the_card(plan):
    """At the probe's shape (B16, K512, N2048, L96) the stream's 384 blocks
    of 8 warps all fit on the 132 SMs at once (3 a SM by shared memory)."""
    blocks = plan.stream_blocks(96, 16, 512)
    smem = [plan.stream_smem(16, 512, 2048, i4) for i4 in (0, 1)]
    assert blocks == 4 * 96 and plan.stream_warps(512, 2048) == 8
    assert all(3 * (s + 1024) <= 233472 for s in smem), smem
    assert blocks <= 132 * 3


@pytest.mark.parametrize("int4", [0, 1], ids=["int8", "int4"])
def test_shared_memory_fits(plan, int4):
    """Every launch's dynamic shared memory fits a block (227 KB), at every
    m16 tile count and at K far past one staged piece of x."""
    for r in (1, 16, 17, 33, 64, 65, 300):
        for k, n in [(512, 2048), (2048, 512), (9216, 512), (16384, 128), (72, 200)]:
            kp = k // 2 if int4 else k
            assert plan.matmul_smem(kp, n, r, int4) <= SMEM_PER_BLOCK, (r, k, n)
        for k, n in [(512, 2048), (4096, 4096), (72, 144), (40, 200), (8192, 8192)]:
            assert plan.stream_smem(r, k, n, int4) <= SMEM_PER_BLOCK, (r, k, n)


def _banks(word_addrs):
    return len({a % 32 for a in word_addrs})


@pytest.mark.parametrize("sw", [1, 4])
def test_ring_rows_read_without_bank_conflicts(plan, sw):
    """A lane (g, t) of the warp on strip h reads 4 bytes at byte 32h + 4g
    of rows 2t, 2t + 1, 2t + 8 and 2t + 9: each of those four reads of a
    warp falls on 32 distinct banks at the ring's row stride."""
    rb = plan.ring_row_bytes(sw)
    assert rb % 16 == 0 and rb >= 32 * sw
    for h in range(sw):
        for off in (0, 1, 8, 9):
            words = [((2 * (lane & 3) + off) * rb + 32 * h + 4 * (lane >> 2)) // 4
                     for lane in range(32)]
            assert _banks(words) == 32, (sw, h, off)


@pytest.mark.parametrize("rows", [16, 32, 64, 128, 200, 256, 512, 550])
def test_x_rows_for_ldmatrix(plan, rows):
    """A staged x row holds whole ring chunks (the core runs every k-step
    of a chunk on zeros past K) and is padded so that the 8 rows an
    ldmatrix phase reads (16 bytes each) fall on distinct banks."""
    xr = plan.x_row(rows)
    assert xr >= rows and (xr - plan.x_pad()) % plan.chunk() == 0 and xr % 8 == 0
    words = [w for r in range(8) for w in range(r * xr // 2, r * xr // 2 + 4)]
    assert _banks(words) == 32
