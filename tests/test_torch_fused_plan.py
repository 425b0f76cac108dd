"""The host-side plan of row 1's launches (``csrc/fused_plan.h``: the GEMV
splits and clusters, their shared memory, the attention launch's shared
memory and window), held on the CPU.

The header is plain C++, compiled into the kernels by nvcc; here the same
header is compiled by the host's C++ compiler into a small library and
called through ctypes.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK
from synthanatomy_tpu_torch.ops import fused_decode as fd

CSRC = Path(fd.__file__).resolve().parent.parent / "csrc"

SHIM = """
#include "fused_plan.h"
extern "C" {
int split_rows(int kp, int n, int b) { return fdp::split_rows(kp, n, b); }
int splits(int kp, int n, int b) { return fdp::splits(kp, n, b); }
int gemv_smem(int int4) { return fdp::gemv_smem(int4); }
int max_rows() { return fdp::kMaxRows; }
int max_splits() { return fdp::kMaxSplits; }
int gemv_fits(int d, int hd, int f, int int4) { return fdp::gemv_fits(d, hd, f, int4); }

int k_step() { return fdp::kKStep; }
int batch_tile() { return fdp::kBT; }
int col_tile() { return fdp::kNT; }
int window_first(int t, int r, int w) { return fdp::window_first(t, r, w); }
int window_rows(int r, int w) { return fdp::window_rows(r, w); }
int local_cap(int dh, int r, int w, int elem) { return fdp::local_cap(dh, r, w, elem); }
int local_smem(int dh, int r, int w, int elem) { return fdp::local_smem(dh, r, w, elem); }
int favor_smem(int dh, int m) { return fdp::favor_smem(dh, m); }
int attn_smem(int dh, int m, int lh, int r, int w, int elem) {
  return fdp::attn_smem(dh, m, lh, r, w, elem);
}
}
"""

# the paper prior's four products (K, N) at d512, 16 heads of 64, FF 2048
PAPER_PRODUCTS = [(512, 1536), (512, 512), (512, 2048), (2048, 512)]


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/fused_plan.h"
    out = tmp_path_factory.mktemp("fused_plan")
    (out / "shim.cpp").write_text(SHIM)
    lib = out / "libfused_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(out / "shim.cpp"), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    assert so.batch_tile() == 16 and so.col_tile() == 32 and so.k_step() == 16
    return so


@pytest.mark.parametrize("int4", [0, 1], ids=["int8", "int4"])
def test_paper_products_spread_over_the_sms(plan, int4):
    """At B16 each of the paper's four products spreads over at least 132
    blocks (the H100's SMs), in splits of whole k-steps that cover K, one
    cluster of at most 16 a column tile."""
    for K, N in PAPER_PRODUCTS:
        kp = K // 2 if int4 else K
        rows, n = plan.split_rows(kp, N, 16), plan.splits(kp, N, 16)
        assert (N // 32) * n >= 132, (K, N)
        assert rows % 16 == 0 and rows <= plan.max_rows(), (K, N)
        assert (n - 1) * rows < kp <= n * rows and n <= plan.max_splits() == 16, (K, N)
    assert plan.gemv_fits(512, 512, 2048, int4)


@pytest.mark.parametrize("B", [1, 2, 8, 16, 17, 40])
def test_splits_cover_k_in_whole_steps(plan, B):
    """Any batch and width the step takes: whole k-steps, at most
    kMaxSplits splits (one cluster), no empty split, at least half of
    min(132, what K allows) blocks (rounding rows to whole k-steps may
    drop a split), and the split depends on the product's shape and the
    batch alone (never on the depth).  A split holds at most kMaxRows
    rows (one staging of its block) until K passes kMaxSplits x kMaxRows
    packed rows; past that the 16 splits are as even as whole k-steps
    allow, and a block walks its rows kMaxRows at a time."""
    for K in (128, 256, 384, 512, 1024, 2048, 4096, 8192, 9216, 16384):
        for N in (128, 384, 512, 1536, 2048, 4096, 6144):
            for kp in (K, K // 2):
                rows, n = plan.split_rows(kp, N, B), plan.splits(kp, N, B)
                assert rows % 16 == 0 and rows >= 16
                assert (n - 1) * rows < kp <= n * rows and n <= 16
                if kp <= plan.max_splits() * plan.max_rows():
                    assert rows <= plan.max_rows(), (kp, N, B)
                else:
                    assert n == plan.max_splits() and rows == -(-kp // 256) * 16, (kp, N, B)
                tiles = (N // 32) * -(-B // 16)
                assert 2 * tiles * n >= min(132, tiles * min(16, kp // 16))


def test_gemv_fits_the_wrapper_gate(plan):
    """Every width the wrapper's gate lets through (``_widths_ok``: dim
    and FF multiples of 128, dh 64 or 128, any number of heads) is one the
    GEMVs take, with int8 and with packed int4 weights: the plan sets no
    upper bound on K."""
    from synthanatomy_tpu_torch.ops.fused_decode import _widths_ok

    seen = 0
    for D in (128, 384, 512, 1152, 2048, 4096, 8192):
        for F in (D, 4 * D, 128 * 72):
            for dh in (64, 128):
                for H in (2, 3, 16, 40):
                    assert _widths_ok(1, dh, D, F)
                    for int4 in (0, 1):
                        assert plan.gemv_fits(D, H * dh, F, int4), (D, H, dh, F, int4)
                        seen += 1
    assert seen == 7 * 3 * 2 * 4 * 2
    assert not _widths_ok(1, 64, 4096 + 64, 4 * 4096) and not _widths_ok(1, 32, 512, 2048)
    assert not plan.gemv_fits(512, 512, 2048 + 16, 0)  # an FF width off the column tiles


def test_gemv_shared_memory(plan):
    """A GEMV block's shared memory stays under the 48 KB of a launch
    without an opt-in (the kernel holds its struct to this size)."""
    for int4 in (0, 1):
        assert plan.gemv_smem(int4) <= 48 * 1024


def test_paper_shape_fits(plan):
    """The paper shape fits: the GEMVs and the attention launch's shared
    memory, with int8 and with bf16 rings."""
    cfg = fd.FusedDecodeConfig(depth=24, batch=16, dim=512, heads=16, dim_head=64,
                               local_heads=8, local_window=420, nb_features=256)
    assert plan.attn_smem(64, 256, 8, cfg.ring_size, 420, 1) <= SMEM_PER_BLOCK
    assert plan.attn_smem(64, 256, 8, cfg.ring_size, 420, 2) <= SMEM_PER_BLOCK
    assert plan.gemv_fits(512, 512, 2048, 0) and plan.gemv_fits(512, 512, 2048, 1)


@pytest.mark.parametrize("R,W", [(128, 12), (448, 420), (128, 128), (64, 100), (128, 1)])
def test_window_is_the_plain_versions_mask(plan, R, W):
    """The slots the local blocks read, positions window_first(t) .. t − 1
    in slots p mod R, are exactly the plain version's valid slots
    (``fused_decode_step_ref``), and never more than window_rows."""
    for t in list(range(0, 2 * R + 3)) + [1000, 1401]:
        p0 = plan.window_first(t, R, W)
        got = sorted(p % R for p in range(p0, t))
        slots = torch.arange(R)
        k_pos = t - 1 - torch.remainder(t - 1 - slots, R)
        valid = (k_pos >= 0) & (k_pos > t - W)
        assert got == torch.nonzero(valid).flatten().tolist(), (R, W, t)
        assert t - p0 <= plan.window_rows(R, W)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("elem", [1, 2], ids=["int8", "bf16"])
def test_local_staging_fits(plan, dh, elem):
    """The local blocks' shared memory fits the card for every window up to
    a few thousand; the whole window is staged at once (K and V side by
    side) at the paper's window 420 but for d 128 bf16 rings, which stream
    it in chunks."""
    for W in (1, 2, 12, 64, 420, 1000, 2048, 4000):
        R = max(128, -(-W // 64) * 64)
        assert plan.local_smem(dh, R, W, elem) <= SMEM_PER_BLOCK, (W, R)
        cap = plan.local_cap(dh, R, W, elem)
        assert 1 <= cap <= max(1, plan.window_rows(R, W))
    whole = plan.local_cap(dh, 448, 420, elem) == plan.window_rows(448, 420)
    assert whole == (dh * elem < 256)
    for m in (64, 128, 256):
        assert plan.favor_smem(dh, m) <= SMEM_PER_BLOCK
