"""The host-side plan of row 7's tensor-core tile route (``csrc/res_plan.h``:
the route's gate, the tile walk and its halo window, the swizzle, the
dW1 tap groups, the partial-sum chunks and the launches' shared memory),
held on the CPU.

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
from synthanatomy_tpu_torch.ops import res_stack as rs

CSRC = Path(rs.__file__).resolve().parent.parent / "csrc"
SMEM_PER_SM = 233472  # the H100's 228 KB of shared memory an SM

SHIM = """
#include "res_plan.h"
extern "C" {
int tile_route(int c, int r, int elem) { return rp::tile_route(c, r, elem); }
int tiles(int d, int h, int w) { return rp::tiles(d, h, w); }
void tile_origin(int g, int d, int h, int w, int* out) {
  const rp::Origin o = rp::tile_origin(g, d, h, w);
  out[0] = o.b; out[1] = o.z0; out[2] = o.y0; out[3] = o.x0;
}
void tile_dims(int* out) {
  out[0] = rp::kTZ; out[1] = rp::kTY; out[2] = rp::kTW; out[3] = rp::kTM; out[4] = rp::kWin;
  out[5] = rp::kXRows; out[6] = rp::kNP; out[7] = rp::kKC;
}
int tile_voxel(int m, int axis) {
  return axis == 0 ? rp::tile_z(m) : axis == 1 ? rp::tile_y(m) : rp::tile_x(m);
}
int win_centre(int m) { return rp::win_centre(m); }
int tap_shift(int t) { return rp::tap_shift(t); }
int tap_offset(int t, int axis) {
  return axis == 0 ? rp::tap_dz(t) : axis == 1 ? rp::tap_dy(t) : rp::tap_dx(t);
}
int xrow(int m, int dx) { return rp::xrow(m, dx); }
int elem_at(int row, int col, int cols) { return rp::elem_at(row, col, cols); }
int core_steps(int k) { return rp::core_steps(k); }
int group_tap(int g, int i) { return rp::group_tap(g, i); }
int groups() { return rp::kGroups; }
int group_taps() { return rp::kGroupTaps; }
int c_blocks(int c) { return rp::c_blocks(c); }
int chunk_len(int n, int want) { return rp::chunk_len(n, want); }
int chunk_count(int n, int want) { return rp::chunk_count(n, want); }
int dw1_chunks(int b, int d, int h, int w) { return rp::dw1_chunks(b, d, h, w); }
int da_chunks(int b, int d, int h, int w) { return rp::da_chunks(b, d, h, w); }
int dw1_chunk_target() { return rp::kDw1Chunks; }
int da_chunk_target() { return rp::kDaChunks; }
long long part_floats(int b, int c, int r, int d, int h, int w) {
  return rp::part_floats(b, c, r, d, h, w);
}
void grids(int b, int c, int d, int h, int w, int* out) {
  const rp::Grid core = rp::core_grid(b, d, h, w), dw1 = rp::dw1_grid(c, rp::dw1_chunks(b, d, h, w));
  out[0] = core.x; out[1] = core.y; out[2] = core.z; out[3] = dw1.x; out[4] = dw1.y; out[5] = dw1.z;
}
void smem(int* out) {
  out[0] = rp::kCoreSmem; out[1] = rp::kDaSmem; out[2] = rp::kDw1Smem; out[3] = rp::kMaxSmem;
  out[4] = rp::kWinBytes; out[5] = rp::kTileBytes; out[6] = rp::kStages * rp::kSliceBytes;
  out[7] = rp::kCoreThreads; out[8] = rp::kThreads;
}
}
"""

# (B, D, H, W): ragged in every direction, one voxel, and the paper's level
VOLUMES = [(1, 5, 6, 7), (2, 9, 10, 11), (1, 7, 9, 70), (3, 1, 1, 1), (1, 4, 4, 8),
           (2, 13, 3, 17)]


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/res_plan.h"
    out = tmp_path_factory.mktemp("res_plan")
    (out / "shim.cpp").write_text(SHIM)
    lib = out / "libres_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(out / "shim.cpp"), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    so.part_floats.restype = ctypes.c_longlong
    return so


def _ints(fn, n, *args):
    buf = (ctypes.c_int * n)()
    fn(*args, buf)
    return list(buf)


def _dims(plan):
    tz, ty, tw, tm, win, xrows, np_, kc = _ints(plan.tile_dims, 8)
    return dict(tz=tz, ty=ty, tw=tw, tm=tm, win=win, xrows=xrows, np=np_, kc=kc)


@pytest.mark.parametrize("vol", VOLUMES, ids=lambda v: "x".join(map(str, v)))
def test_tile_walk_covers_every_voxel_once(plan, vol):
    """The tiles of the walk (one block each: the forward, dx and, in
    chunks, dW1) hold every voxel of every volume exactly once, the
    ragged far edges included."""
    b, d, h, w = vol
    dm = _dims(plan)
    n = plan.tiles(d, h, w)
    assert n == -(-d // dm["tz"]) * -(-h // dm["ty"]) * -(-w // dm["tw"])
    seen = np.zeros((b, d, h, w), dtype=np.int64)
    for g in range(b * n):
        vb, z0, y0, x0 = _ints(plan.tile_origin, 4, g, d, h, w)
        for m in range(dm["tm"]):
            z = z0 + plan.tile_voxel(m, 0)
            y = y0 + plan.tile_voxel(m, 1)
            x = x0 + plan.tile_voxel(m, 2)
            if z < d and y < h and x < w:
                seen[vb, z, y, x] += 1
    assert (seen == 1).all()
    core, dw1 = _ints(plan.grids, 6, b, 8, d, h, w)[:3], _ints(plan.grids, 6, b, 8, d, h, w)[3:]
    assert core == [b * n, 1, 1]
    assert dw1 == [plan.groups(), 1, plan.dw1_chunks(b, d, h, w)]


def test_halo_window_covers_every_tap(plan):
    """Each tile voxel's 27 taps are rows of the tile's halo window (its
    row = its centre + the tap's shift), and that row holds the voxel
    shifted by the tap's (dz, dy, dx); the dx conv reads tap 26 − t, the
    opposite shift."""
    dm = _dims(plan)
    wz, wy, wx = dm["tz"] + 2, dm["ty"] + 2, dm["tw"] + 2
    assert dm["win"] == wz * wy * wx
    offsets = set()
    for t in range(27):
        off = tuple(plan.tap_offset(t, a) for a in range(3))
        offsets.add(off)
        assert tuple(plan.tap_offset(26 - t, a) for a in range(3)) == tuple(-o for o in off)
        for m in range(dm["tm"]):
            v = plan.win_centre(m) + plan.tap_shift(t)
            assert 0 <= v < dm["win"]
            want = tuple(plan.tile_voxel(m, a) + 1 + off[a] for a in range(3))
            assert (v // (wy * wx), v // wx % wy, v % wx) == want
    assert offsets == {(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)}


def test_dw1_tap_groups_cover_the_taps_once(plan):
    """The dW1 tap groups hold the 27 taps once; a group's taps share their
    (dz, dy) and read one x window shifted by it, each tap the rows of
    its dx."""
    dm = _dims(plan)
    taps = [plan.group_tap(g, i) for g in range(plan.groups()) for i in range(plan.group_taps())]
    assert sorted(taps) == list(range(27))
    for g in range(plan.groups()):
        group = [plan.group_tap(g, i) for i in range(plan.group_taps())]
        assert len({(plan.tap_offset(t, 0), plan.tap_offset(t, 1)) for t in group}) == 1
        assert [plan.tap_offset(t, 2) for t in group] == [-1, 0, 1]
    for m in range(dm["tm"]):
        for dx in (-1, 0, 1):
            v = plan.xrow(m, dx)
            assert 0 <= v < dm["xrows"]
            assert (v // (dm["tw"] + 2), v % (dm["tw"] + 2)) == (
                plan.tile_voxel(m, 0) * dm["ty"] + plan.tile_voxel(m, 1),
                plan.tile_voxel(m, 2) + 1 + dx)


def test_swizzle_spreads_ldmatrix_rows_over_the_banks(plan):
    """Within a staged row the 16-byte chunks are a permutation; the 8
    consecutive rows an ldmatrix phase reads at one logical chunk fall on
    8 distinct 16-byte bank groups, for the 64- and 128-column rows of the
    halo core, da and dW1."""
    for cols, at in [(cols, lambda r, c, cols=cols: plan.elem_at(r, c, cols)) for cols in (64, 128)]:
        for row in range(64):
            starts = sorted(at(row, 8 * j) - row * cols for j in range(cols // 8))
            assert starts == list(range(0, cols, 8))
        for row0 in range(64):
            for j in range(cols // 8):
                groups = {at(row0 + i, 8 * j) * 2 // 16 % 8 for i in range(8)}
                assert len(groups) == 8


def test_route_gate_and_shared_memory(plan):
    """bf16 shapes with C and R multiples of 8 up to 128 take the tile
    route; everything else the gate admits (f32, odd or wider channels,
    R up to 512) takes the GEMM route.  Every tile-route launch fits a
    block's shared memory, the halo core two blocks an SM, and the
    staged tiles that reuse the window and the ring fit there."""
    core, da, dw1, mx, win, tile, ring, core_threads, threads = _ints(plan.smem, 9)
    assert mx == max(core, da, dw1) <= SMEM_PER_BLOCK
    assert 2 * (core + 1024) <= SMEM_PER_SM
    assert tile <= win and tile <= ring  # h and y tiles in the window, W2 in the ring
    assert (core_threads, threads) == (128, 256)
    for c in range(1, 200):
        for r in (1, 4, 8, 12, 16, 24, 40, 64, 120, 128, 136, 256, 512):
            want = c % 8 == 0 and r % 8 == 0 and 8 <= c <= 128 and 8 <= r <= 128
            assert bool(plan.tile_route(c, r, 2)) == want, (c, r)
            assert not plan.tile_route(c, r, 4)
            if want:
                assert plan.core_steps(c) == 27 * -(-c // 64) and plan.core_steps(r) >= 27
                assert plan.c_blocks(c) in (1, 2)
    assert plan.tile_route(128, 128, 2)  # the paper VQ-VAE's fused layers


@pytest.mark.parametrize("n", [1, 2, 43, 44, 45, 263, 264, 265, 5600, 16800])
def test_chunks_cover_in_fixed_order(plan, n):
    """Partial-sum chunks: whole runs of tiles (dW1) or 128-voxel
    sub-tiles (da) in increasing order, none empty, at most the target
    count, set by the count alone; the reduction sums them in that
    order."""
    for want in (plan.dw1_chunk_target(), plan.da_chunk_target()):
        length, count = plan.chunk_len(n, want), plan.chunk_count(n, want)
        starts = [q * length for q in range(count)]
        assert count <= want and starts[0] == 0 and starts[-1] < n <= count * length
        assert (length, count) == (plan.chunk_len(n, want), plan.chunk_count(n, want))


def test_partials_and_paper_grids(plan):
    """At the paper shape (B3, 80 x 112 x 80, C = R = 128): 5600 tiles a
    volume, 44 dW1 chunks (9 groups x 2 channel blocks x 44 = 792 blocks,
    whole waves on 132 SMs) and 263 da chunks of 64 sub-tiles; the
    scratch holds each chunk's partials."""
    b, d, h, w, c, r = 3, 80, 112, 80, 128, 128
    assert plan.tiles(d, h, w) == 5600
    n1, n2 = plan.dw1_chunks(b, d, h, w), plan.da_chunks(b, d, h, w)
    assert (n1, n2) == (44, 263)
    assert plan.part_floats(b, c, r, d, h, w) == n1 * 27 * c * r + n2 * (r * c + r + c)
    assert _ints(plan.grids, 6, 1, c, d, h, w)[3:] == [9, 2, 44]
    assert 9 * 2 * 44 % 132 == 0


@pytest.mark.parametrize("vol", [(3, 9, 10, 17), (3, 80, 112, 80)],
                         ids=lambda v: "x".join(map(str, v)))
def test_dw1_chunks_cross_volumes(plan, vol):
    """At B3 a dW1 chunk of whole tiles holds the last tiles of one
    volume and the first of the next (the kernels read each tile's
    volume from its walk index), so the card's checks at these shapes
    (chip_smoke.py phase 9, tests/test_torch_kernels_gpu.py) reach that
    case: 27 tiles a volume in chunks of 2, and 5600 in chunks of 382."""
    b, d, h, w = vol
    n = plan.tiles(d, h, w)
    length = plan.chunk_len(b * n, plan.dw1_chunk_target())
    assert length > 1
    crossing = [q for q in range(plan.dw1_chunks(b, d, h, w))
                if len({_ints(plan.tile_origin, 4, g, d, h, w)[0]
                        for g in range(q * length, min((q + 1) * length, b * n))}) > 1]
    assert crossing and n % length
