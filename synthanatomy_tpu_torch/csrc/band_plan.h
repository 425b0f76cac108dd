// The plan of the local-attention tile core (band_attention.cuh) that the
// host needs: tile geometry, row 6's tile walk and the dynamic shared
// memory of row 6's launches.  Plain C++ with no CUDA header, so the one
// definition is compiled into the kernels by nvcc and, for the CPU tests
// (tests/test_torch_band_plan.py), by a host compiler.

#pragma once

#ifdef __CUDACC__
#define BAND_HD __host__ __device__
#else
#define BAND_HD
#endif

namespace band {

constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kTileMaxD = 128;  // the widest head row 6's tile form stages

// row stride (elements of `elem` bytes) of a staged tile of dp columns:
// 16 bytes of padding, so the 8 rows an ldmatrix phase reads fall on
// distinct banks
BAND_HD constexpr int row_ld(int elem, int dp) { return dp + 16 / elem; }

BAND_HD constexpr int tiles(int n) { return (n + kTile - 1) / kTile; }

// ---------------------------------------------------------------------------
// row 6's tile walk
// ---------------------------------------------------------------------------

// the first key tile with a key visible to query tile qt (its last is qt)
BAND_HD constexpr int first_key_tile(int qt, int w) {
  return qt * kTile - w + 1 > 0 ? (qt * kTile - w + 1) / kTile : 0;
}

// the last query tile with a query that sees a key of tile kt (its first is kt)
BAND_HD constexpr int last_query_tile(int kt, int n, int w) {
  return (kt * kTile + kTile - 2 + w < n - 1 ? kt * kTile + kTile - 2 + w : n - 1) / kTile;
}

// every pair of queries (< n) and keys of the two tiles is visible: no mask
BAND_HD constexpr bool tile_full(int qt, int kt, int n, int w) {
  return kt < qt && kt * kTile >= qt * kTile + kTile - w && qt * kTile + kTile <= n;
}

// ---------------------------------------------------------------------------
// row 6's shared memory (bytes)
// ---------------------------------------------------------------------------

// The tile form (d ≤ kTileMaxD): the head zero-padded to 64 or 128.
BAND_HD constexpr int padded_d(int d) { return d <= 64 ? 64 : kTileMaxD; }

// Slots of the ring: 3 where a staged row is at most 128 bytes (bf16, d ≤
// 64: a pass-1 step's products are too short for one tile in flight to
// hide the copy), else 2, which keeps f32 at d 128 inside shared memory.
BAND_HD constexpr int ring_slots(int elem, int dp) { return dp * elem <= 128 ? 3 : 2; }

BAND_HD constexpr int tile_bytes(int elem, int dp) { return kTile * row_ld(elem, dp) * elem; }

// forward Q + slots x (K, V); dq Q, g + slots x (K, V); dk/dv K, V +
// slots x (Q, g, 3 row statistics)
BAND_HD constexpr int fwd_smem(int elem, int dp) {
  return (1 + 2 * ring_slots(elem, dp)) * tile_bytes(elem, dp);
}
BAND_HD constexpr int dq_smem(int elem, int dp) {
  return (2 + 2 * ring_slots(elem, dp)) * tile_bytes(elem, dp);
}
BAND_HD constexpr int dkv_smem(int elem, int dp) {
  return (2 + 2 * ring_slots(elem, dp)) * tile_bytes(elem, dp) +
         ring_slots(elem, dp) * 3 * kTile * 4;
}

// The band form (d > kTileMaxD): the earlier FMA kernels, 32 rows a block.
constexpr int kQT = 32;  // query rows per block (forward, dq)
constexpr int kKT = 32;  // key rows per block (dk/dv)
constexpr int kQS = 64;  // query tile of the dk/dv walk
constexpr int kGemmFloats = 16 * (32 + 64);  // block_gemm.cuh's staging tiles (sa::Gemm<32, 64>)

// shared floats of the forward and dq kernels: `arrays` score bands of
// 32 x (32 + w − 1), the row sums, then the staging tiles (16-byte aligned)
BAND_HD constexpr int band_ld(int w) { return kQT + w - 1; }
BAND_HD constexpr int band_stage(int w, int arrays) {
  return (arrays * kQT * band_ld(w) + kQT + 3) / 4 * 4;
}

// the dk/dv kernel: P and dS tiles (32 x 64), dK and dV sums (32 x d)
BAND_HD constexpr int dkv_stage(int d) { return (2 * kKT * kQS + 2 * kKT * d + 3) / 4 * 4; }

constexpr long long band_smem(int d, int w) {
  return 4LL * ((band_stage(w, 2) > dkv_stage(d) ? band_stage(w, 2) : dkv_stage(d)) +
                kGemmFloats);
}

// The largest of the three kernels that local_fwd/local_bwd launch for
// head dim d, window w and `elem`-byte inputs: the tile form's (no window
// bound) for d ≤ kTileMaxD, else the band form's.
constexpr long long local_smem_bytes(int d, int w, int elem) {
  return d <= kTileMaxD ? dkv_smem(elem, padded_d(d)) : band_smem(d, w);
}

}  // namespace band
