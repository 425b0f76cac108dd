"""The host-side plan of row 5's chunk-parallel route (``csrc/favor_plan.h``:
the route's gate, the chunk walk and its 64-row sub-tiles, the order of the
state scan, the workspace layout, each launch's grid and shared memory),
held on the CPU.

The header is plain C++, compiled into the kernels by nvcc; here the same
header is compiled by the host's C++ compiler into a small library and
called through ctypes.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import pytest

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK
from synthanatomy_tpu_torch.ops import favor_attention as fa

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
SMEM_PER_SM = 233472  # the H100's 228 KB of shared memory an SM
KINDS = {"state": 0, "scan": 1, "fwd": 2, "dq": 3, "dkv": 4}

SHIM = """
#include "favor_plan.h"
extern "C" {
int tile_route(int d, int m, int chunk, int elem) { return fp::tile_route(d, m, chunk, elem); }
int padded_m(int m) { return fp::padded_m(m); }
int chunks(int n, int chunk) { return fp::chunks(n, chunk); }
int chunk_rows(int c, int n, int chunk) { return fp::chunk_rows(c, n, chunk); }
int subs(int chunk) { return fp::subs(chunk); }
void grid(int kind, int bh, int n, int chunk, int mp, int dirs, int* out) {
  const fp::Grid g = fp::grid(kind, bh, n, chunk, mp, dirs);
  out[0] = g.x; out[1] = g.y; out[2] = g.z;
}
int sub_rows(int c, int s, int n, int chunk) { return fp::sub_rows(c, s, n, chunk); }
int scan_chunk(int step, int nc, int dir) { return fp::scan_chunk(step, nc, dir); }
int state_floats(int mp) { return fp::state_floats(mp); }
int arrays() { return fp::kArrays; }
long long array_bytes(int a, int bh, int n, int chunk, int mp, int elem, int bwd) {
  return fp::array_bytes(a, bh, n, chunk, mp, elem, bwd != 0);
}
long long array_offset(int a, int bh, int n, int chunk, int mp, int elem, int bwd) {
  return fp::array_offset(a, bh, n, chunk, mp, elem, bwd != 0);
}
long long work_bytes(int bh, int n, int chunk, int mp, int elem, int bwd) {
  return fp::work_bytes(bh, n, chunk, mp, elem, bwd != 0);
}
long long blocks(int kind, int bh, int n, int chunk, int mp, int dirs) {
  return fp::blocks(kind, bh, n, chunk, mp, dirs);
}
int smem_bytes(int kind, int elem, int mp) { return fp::smem_bytes(kind, elem, mp); }
int route_smem_bytes(int elem, int mp) { return fp::route_smem_bytes(elem, mp); }
int blocks_per_sm(int kind, int elem, int mp) { return fp::blocks_per_sm(kind, elem, mp); }
int region_offset(int kind, int r, int elem, int mp) { return fp::region_offset(kind, r, elem, mp); }
int region_bytes(int kind, int r, int elem, int mp) { return fp::region_bytes(kind, r, elem, mp); }
int regions() { return fp::kRegions; }
void consts(int* out) {
  out[0] = fp::kSub; out[1] = fp::kThreads; out[2] = fp::kDP; out[3] = fp::kMaxM;
  out[4] = fp::kFwdLaunches; out[5] = fp::kBwdLaunches; out[6] = fp::kSmemPerBlock;
}
}
"""

# (n, chunk): ragged last chunks, L < chunk, L a multiple of the chunk, one
# row, chunks that are not multiples of the 64-row sub-tile, and the paper's
WALKS = [(37, 16), (100, 128), (300, 128), (1400, 128), (1401, 128), (1, 128), (128, 128),
         (129, 64), (200, 100), (65, 65), (500, 200), (63, 1)]


def _load_gpu_tests():
    spec = importlib.util.spec_from_file_location(
        "_gpu_tests", Path(__file__).resolve().parent / "test_torch_kernels_gpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/favor_plan.h"
    out = tmp_path_factory.mktemp("favor_plan")
    (out / "shim.cpp").write_text(SHIM)
    lib = out / "libfavor_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(out / "shim.cpp"), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    for fn in (so.array_bytes, so.array_offset, so.work_bytes, so.blocks):
        fn.restype = ctypes.c_longlong
    return so


def _consts(plan):
    buf = (ctypes.c_int * 7)()
    plan.consts(buf)
    return dict(zip(("sub", "threads", "dp", "max_m", "fwd", "bwd", "smem"), buf))


@pytest.mark.parametrize("n,chunk", WALKS, ids=lambda x: str(x))
def test_chunk_walk_covers_every_row_once(plan, n, chunk):
    """The chunks and their 64-row sub-tiles (one consumer block each) hold
    every row once, the ragged last chunk and L < chunk included; the
    blocks past a chunk's end get 0 rows and return."""
    sub = _consts(plan)["sub"]
    nc = plan.chunks(n, chunk)
    seen = [0] * n
    for c in range(nc):
        cl = plan.chunk_rows(c, n, chunk)
        assert 1 <= cl <= chunk and (cl == chunk or c == nc - 1)
        total = 0
        for s in range(plan.subs(chunk)):
            rows = plan.sub_rows(c, s, n, chunk)
            assert 0 <= rows <= sub
            assert (rows == 0) == (s * sub >= cl)
            for i in range(rows):
                seen[c * chunk + s * sub + i] += 1
            total += rows
        assert total == cl
    assert seen == [1] * n


@pytest.mark.parametrize("n,chunk", WALKS, ids=lambda x: str(x))
def test_state_blocks_cover_every_sub_tile_once(plan, n, chunk):
    """The state launch's grid holds one block per (side, sub-tile, chunk,
    batch·head); the blocks with rows are exactly the sub-tiles of the
    chunk walk, which the scan sums (the others return without writing)."""
    buf = (ctypes.c_int * 3)()
    for dirs in (1, 2):
        plan.grid(KINDS["state"], 3, n, chunk, 64, dirs, buf)
        assert list(buf) == [dirs * plan.subs(chunk), plan.chunks(n, chunk), 3]
    plan.grid(KINDS["fwd"], 3, n, chunk, 64, 1, buf)
    assert list(buf) == [plan.subs(chunk), plan.chunks(n, chunk), 3]
    with_rows = sum(plan.sub_rows(c, s, n, chunk) > 0
                    for c in range(plan.chunks(n, chunk)) for s in range(plan.subs(chunk)))
    assert with_rows == sum(-(-plan.chunk_rows(c, n, chunk) // 64)
                            for c in range(plan.chunks(n, chunk)))


@pytest.mark.parametrize("nc", [1, 2, 3, 11, 12])
def test_scan_order_is_the_sequential_carry(plan, nc):
    """Direction 0 visits the chunks in ascending order, direction 1 in
    descending order; the exclusive scan hands chunk c exactly the chunks
    strictly before it (S, z) or strictly after it (dS, dz), summed in the
    order the sequential carry adds them."""
    for direction in (0, 1):
        order = [plan.scan_chunk(step, nc, direction) for step in range(nc)]
        assert order == (list(range(nc)) if direction == 0 else list(range(nc))[::-1])
        seen, got = [], {}
        for c in order:
            got[c] = list(seen)
            seen.append(c)
        for c in range(nc):
            want = list(range(c)) if direction == 0 else list(range(nc - 1, c, -1))
            assert got[c] == want


@pytest.mark.parametrize("bh,n,chunk,m,elem", [(48, 1400, 128, 256, 2), (48, 1401, 128, 256, 2),
                                               (16, 1400, 128, 128, 2), (6, 37, 16, 32, 4),
                                               (2, 100, 64, 128, 4), (3, 300, 128, 256, 4)])
def test_workspace_arrays_do_not_overlap(plan, bh, n, chunk, m, elem):
    """The workspace arrays of a forward and of a backward call are 256-byte
    aligned, in bounds and disjoint, each of the size its layout gives (a
    chunk's own state in one part per 64-row sub-tile); the forward holds
    only the key side and direction 0."""
    mp = plan.padded_m(m)
    nc = bh * plan.chunks(n, chunk)
    rows, parts = bh * n, nc * plan.subs(chunk)
    want = [rows * mp * elem, rows * mp * elem, rows * 64 * elem, rows * 4,
            parts * plan.state_floats(mp) * 4, parts * plan.state_floats(mp) * 4,
            nc * mp * 64 * elem, nc * mp * 64 * elem, nc * mp * 4, nc * mp * 4]
    fwd_only = {0, 4, 6, 8}
    for bwd in (0, 1):
        spans = []
        for a in range(plan.arrays()):
            size = plan.array_bytes(a, bh, n, chunk, mp, elem, bwd)
            assert size == (want[a] if bwd or a in fwd_only else 0)
            off = plan.array_offset(a, bh, n, chunk, mp, elem, bwd)
            assert off % 256 == 0
            spans.append((off, off + size))
        spans.sort()
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 <= b0
        assert spans[-1][1] <= plan.work_bytes(bh, n, chunk, mp, elem, bwd)


def test_shared_memory_and_blocks_per_sm(plan):
    """Every launch of the route fits a block's shared memory at every
    width and dtype, its regions disjoint and 128-byte aligned; at the paper
    width (m 256) bf16 puts two blocks of every launch on an SM, f32 one;
    the wrapper's refusal reads the same figure (the largest launch)."""
    c = _consts(plan)
    assert c["smem"] == SMEM_PER_BLOCK and (c["sub"], c["threads"], c["dp"]) == (64, 128, 64)
    for elem in (2, 4):
        for mp in (64, 256):
            biggest = 0
            for name, kind in KINDS.items():
                if name == "scan":
                    assert plan.smem_bytes(kind, elem, mp) == 0
                    continue
                total = plan.smem_bytes(kind, elem, mp)
                assert 0 < total <= SMEM_PER_BLOCK, (name, elem, mp)
                end = 0
                for r in range(plan.regions()):
                    off = plan.region_offset(kind, r, elem, mp)
                    assert off % 128 == 0 and off >= end
                    end = off + plan.region_bytes(kind, r, elem, mp)
                assert end <= total
                biggest = max(biggest, total)
                per_sm = plan.blocks_per_sm(kind, elem, mp)
                assert per_sm * (total + 1024) <= SMEM_PER_SM < (per_sm + 1) * (total + 1024)
            assert plan.route_smem_bytes(elem, mp) == biggest
    for name in ("state", "fwd", "dq", "dkv"):
        assert plan.blocks_per_sm(KINDS[name], 2, 256) == 2, name
        assert plan.blocks_per_sm(KINDS[name], 4, 256) == 1, name


def test_paper_shape_fills_the_card(plan):
    """At the paper shape (B6 x 8 FAVOR heads, L 1400 and the bench's 1401,
    d 64, m 256, chunk 128) every launch but the scan puts at least 132
    blocks (one an SM) on the card: a block per 64-row sub-tile, 1056 in
    the forward's state launch and in each consumer, 2112 in the
    backward's state launch (keys and queries)."""
    for n in (1400, 1401):
        assert plan.blocks(KINDS["state"], 48, n, 128, 256, 1) == 1056
        assert plan.blocks(KINDS["state"], 48, n, 128, 256, 2) == 2112
        for name in ("fwd", "dq", "dkv"):
            assert plan.blocks(KINDS[name], 48, n, 128, 256, 1) == 1056
    assert plan.blocks(KINDS["scan"], 48, 1400, 128, 256, 2) == 2 * 48 * -(-(256 * 65) // 1024)
    c = _consts(plan)
    assert (c["fwd"], c["bwd"]) == (3, 4)


def test_route_gate(plan):
    """The route takes every chunk-parallel shape of the GPU tests, the
    paper and bench shapes and the validation prior's m 128 / d 64; the
    earlier kernels keep d above 64, d not a multiple of 8 and m above
    256 (the GPU tests' fallback shapes)."""
    gpu = _load_gpu_tests()
    for b, h, n, d, m, chunk, dtype in gpu.FAVOR_SHAPES:
        elem = 2 if "bfloat16" in str(dtype) else 4
        assert bool(plan.tile_route(d, m, chunk, elem)) == (d <= 64), (b, h, n, d, m, chunk)
    for d, m, chunk, elem in ((64, 256, 128, 2), (64, 128, 128, 2), (64, 128, 128, 4),
                              (16, 16, 16, 2), (64, 64, 128, 2), (32, 64, 128, 4),
                              (16, 32, 16, 4), (64, 256, 1, 2)):
        assert plan.tile_route(d, m, chunk, elem), (d, m, chunk, elem)
    for d, m, chunk, elem in ((128, 256, 128, 2), (64, 257, 128, 2), (64, 1024, 128, 2),
                              (12, 64, 64, 4), (4, 64, 64, 4), (64, 256, 0, 2),
                              (64, 256, 128, 8)):
        assert not plan.tile_route(d, m, chunk, elem), (d, m, chunk, elem)
    assert [plan.padded_m(m) for m in (1, 64, 65, 128, 129, 256)] == [64, 64, 256, 256, 256, 256]
