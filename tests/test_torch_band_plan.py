"""The host-side plan of row 6's launches (``csrc/band_plan.h``: the tile
walk, the head padding and the shared memory), held on the CPU.

The header is plain C++, compiled into the kernels by nvcc; here the same
header is compiled by the host's C++ compiler into a small library and
called through ctypes.  The plan must refuse nothing that the earlier
kernels' check accepted (their shared memory, ``_earlier_smem`` below, at
most the card's per-block limit: any d, w up to ~850), and the tile walk
must visit exactly the tile pairs that hold a pair of the dense band mask.
The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK
from synthanatomy_tpu_torch.ops import local_attention_flash as lf

CSRC = Path(lf.__file__).resolve().parent.parent / "csrc"
TILE = 64

SHIM = """
#include "band_plan.h"
extern "C" {
int first_key_tile(int qt, int w) { return band::first_key_tile(qt, w); }
int last_query_tile(int kt, int n, int w) { return band::last_query_tile(kt, n, w); }
int tile_full(int qt, int kt, int n, int w) { return band::tile_full(qt, kt, n, w); }
int padded_d(int d) { return band::padded_d(d); }
int tile_max_d() { return band::kTileMaxD; }
int tile_rows() { return band::kTile; }
long long local_smem_bytes(int d, int w, int elem) { return band::local_smem_bytes(d, w, elem); }
}
"""


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed to compile csrc/band_plan.h"
    out = tmp_path_factory.mktemp("band_plan")
    (out / "shim.cpp").write_text(SHIM)
    lib = out / "libband_plan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}",
                    str(out / "shim.cpp"), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    so.local_smem_bytes.restype = ctypes.c_longlong
    assert so.tile_rows() == TILE
    return so


def _earlier_smem(d, w):
    """Shared memory (bytes) of the largest of the earlier kernels (32-row
    blocks, the 32 x (32 + w − 1) f32 score band in shared memory),
    whose check decided what the wrapper took."""
    stage = 16 * (32 + 64)  # block_gemm.cuh staging tiles, floats
    band = (2 * 32 * (32 + w - 1) + 32 + 3) // 4 * 4
    dkv = (2 * 32 * 64 + 2 * 32 * d + 3) // 4 * 4
    return 4 * (max(band, dkv) + stage)


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [16, 64, 100, 128])
def test_plan_refuses_nothing_the_earlier_check_accepted(plan, d, elem):
    accepted = [w for w in range(1, 1200) if _earlier_smem(d, w) <= SMEM_PER_BLOCK]
    assert 840 <= accepted[-1] < 900  # the earlier bound: w up to about 850
    smem = {plan.local_smem_bytes(d, w, elem) for w in accepted + [accepted[-1] + 1, 5000]}
    assert len(smem) == 1 and smem.pop() <= SMEM_PER_BLOCK  # the tile form: no window bound


@pytest.mark.parametrize("d", [129, 200, 512])
def test_plan_band_form_keeps_the_earlier_bound(plan, d):
    """Above 128 the kernels take the earlier band form, with its bound."""
    for w in (1, 37, 420, 850, 900, 4000):
        for elem in (2, 4):
            assert plan.local_smem_bytes(d, w, elem) == _earlier_smem(d, w)


def test_plan_pads_the_head(plan):
    """Every d up to the tile form's widest is zero-padded to 64 or 128,
    and the tile form's shared memory grows only with the padded d."""
    assert plan.tile_max_d() == 128
    for d in range(1, 129):
        dp = plan.padded_d(d)
        assert dp == (64 if d <= 64 else 128)
        for elem in (2, 4):
            assert plan.local_smem_bytes(d, 420, elem) == plan.local_smem_bytes(dp, 1, elem)


@pytest.mark.parametrize("n", [1, 20, 63, 64, 65, 127, 128, 129, 300, 1400])
def test_tile_walk_covers_the_band(plan, n):
    """first_key_tile / last_query_tile visit exactly the tile pairs that
    hold a (query < n, key) pair of the dense band, and tile_full marks
    exactly those whose every pair is in the band."""
    nt = -(-n // TILE)
    for w in (1, 2, 63, 64, 65, 127, 128, 200, 420, 2000):
        band = torch.zeros(nt * TILE, nt * TILE, dtype=torch.bool)
        band[:n, :n] = lf._band(n, w, "cpu")
        blocks = band.view(nt, TILE, nt, TILE)
        has = blocks.any(dim=3).any(dim=1)  # (qt, kt): some visible pair
        full = blocks.all(dim=3).all(dim=1)
        for qt in range(nt):
            want = torch.nonzero(has[qt]).flatten().tolist()
            assert list(range(plan.first_key_tile(qt, w), qt + 1)) == want, (n, w, qt)
        for kt in range(nt):
            want = torch.nonzero(has[:, kt]).flatten().tolist()
            assert list(range(kt, plan.last_query_tile(kt, n, w) + 1)) == want, (n, w, kt)
        for qt in range(nt):
            for kt in range(nt):
                # a query tile past n is never full: its padded rows are masked
                assert bool(plan.tile_full(qt, kt, n, w)) == bool(full[qt, kt]), (n, w, qt, kt)
