// The plan of the launch-overhead tile program (launch_overhead.cu) that
// the host needs: the output tile, the split of the contraction over a
// thread-block cluster, the products a block runs each step, the shared
// memory and its swizzled layout, and the grid.  Plain C++ with no CUDA
// header, so the one definition is compiled into the kernel by nvcc and,
// for the CPU tests (tests/test_torch_overhead_plan.py), by a host
// compiler.
//
// A block is one warpgroup on a 64 × 64 tile of the output and one split
// of K; the splits of a tile are one cluster.  Each step the block runs
// its split's k16 products (wgmma m64n64k16), x's fragments in registers
// for every step, w's slice in shared memory.  A block asks for enough
// shared memory that it is alone on its SM: two blocks of one SM would
// share its tensor cores and halve the step of the whole grid.  After the
// last step each split pushes its f32 sums of every 8-column group to
// that group's owner rank through distributed shared memory; the owner
// adds them in rank order.

#pragma once

#ifdef __CUDACC__
#define OV_HD __host__ __device__
#else
#define OV_HD
#endif

namespace ovp {

constexpr int kTile = 64;         // output rows and columns of a block (wgmma m64 n64)
constexpr int kThreads = 128;     // one warpgroup
constexpr int kDepth = 16;        // the contraction of one product (k16)
constexpr int kMaxProducts = 16;  // k16 products of a split: x's fragments, 4 registers each
constexpr int kMaxCluster = 8;    // the portable cluster
constexpr int kSMs = 132;         // the H100's SMs
constexpr int kMaxK = kDepth * kMaxProducts * kMaxCluster;  // 2048
constexpr int kRowBytes = 128;    // a swizzled row: 64 bf16
constexpr int kSbo = 8 * kRowBytes;  // bytes between 8-row groups of a tile (a swizzle atom)
constexpr int kGroups = kTile / 8;   // 8-column groups of a tile
constexpr int kGroupBytes = kTile * 8 * 4;  // one group's f32 sums: 64 rows of 32 bytes
// Dynamic shared memory a block asks for at least: two blocks of it and
// their 1 KB reserves exceed the SM's 228 KB, so a block has its SM alone.
constexpr int kOneBlockSmem = 116 * 1024;

OV_HD constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
OV_HD constexpr int imin(int a, int b) { return a < b ? a : b; }
OV_HD constexpr int imax(int a, int b) { return a > b ? a : b; }

// M and N whole tiles, K whole products and at most kMaxK (every split
// holds its x fragments in registers)
OV_HD constexpr bool shape_ok(int M, int K, int N) {
  return M > 0 && N > 0 && K >= 0 && M % kTile == 0 && N % kTile == 0 && K % kDepth == 0 &&
         K <= kMaxK;
}
OV_HD constexpr int products(int K) { return K / kDepth; }
OV_HD constexpr int tiles(int M, int N) { return (M / kTile) * (N / kTile); }
// the fewest splits whose products fit the registers
OV_HD constexpr int min_splits(int K) { return imax(1, ceil_div(products(K), kMaxProducts)); }
// k16 products of each split of S (K 0: one, of zeros)
OV_HD constexpr int split_products(int K, int S) { return imax(1, ceil_div(products(K), S)); }
// S with no empty split: the splits that split_products(K, S) need
OV_HD constexpr int trim(int K, int S) {
  return imax(1, ceil_div(products(K), split_products(K, S)));
}
// the first k of split r; its products past K read zeros
OV_HD constexpr int split_k0(int K, int S, int r) { return r * split_products(K, S) * kDepth; }

// Shared memory of a block whose split runs P products in a cluster of
// S.  x's slice (64 rows × 16P k) is K-major in wgmma's 128-byte swizzle:
// atom columns of 64 k one after another, each 64 rows of 128 bytes,
// 16-byte chunk c of row r at c ^ (r % 8).  w's slice (16P rows of k × 64
// columns) follows it, MN-major in the same swizzle: row k of 128 bytes,
// chunk c (columns 8c to 8c + 7) at c ^ (k % 8).  Both start on
// 1024-byte atoms.  Then the sums the block owns: for each rank q of the
// cluster and each owned group u, 64 rows of 8 f32.
OV_HD constexpr int x_tile_bytes(int P) { return ceil_div(P, 4) * kTile * kRowBytes; }
OV_HD constexpr int w_tile_bytes(int P) { return P * kDepth * kRowBytes; }
// the 8-column groups of the tile that rank r of S sums and writes: slot u
// of its buffer holds group r + u·S (so group j is rank j % S's slot j /
// S), for u < owned(S, r) <= owned(S, 0)
OV_HD constexpr int group(int S, int r, int u) { return r + u * S; }
OV_HD constexpr int owned(int S, int r) { return ceil_div(kGroups - r, S); }
OV_HD constexpr int sums_bytes(int S) { return S * owned(S, 0) * kGroupBytes; }
// the byte of rank q's sums of (owned slot u, row) in the owner's buffer
OV_HD constexpr int sums_offset(int S, int q, int u, int row) {
  return (q * owned(S, 0) + u) * kGroupBytes + row * 32;
}
// what a block uses of its kOneBlockSmem: at most 92 KB (P 16, S 7)
OV_HD constexpr int needed_smem(int P, int S) {
  return x_tile_bytes(P) + w_tile_bytes(P) + sums_bytes(S);
}
// the byte of x's (row r, k) in its slice, k a multiple of 8
OV_HD constexpr int x_offset(int r, int k) {
  return (k / 64) * kTile * kRowBytes + r * kRowBytes + ((((k % 64) / 8) ^ (r % 8)) * 16);
}
// the byte of w's (row k, chunk c) in its slice
OV_HD constexpr int w_offset(int k, int c) { return k * kRowBytes + ((c ^ (k % 8)) * 16); }
// the start of product p's 16 rows: its descriptor's offset into w's slice
OV_HD constexpr int w_product_offset(int p) { return p * kDepth * kRowBytes; }

// The splits of K for an (M, K, N) program: as many as fill the SMs once,
// at most a cluster, with no empty split, and only where every cluster of
// the grid is resident at once: fit(S, P) is how many clusters of S blocks
// of P products the card holds together, one block an SM
// (cudaOccupancyMaxActiveClusters; clusters fill whole GPCs, so fewer fit
// than 132 / S: 30 of 4 on the H100).  Where no count fills it so, the
// fewest splits the registers allow.
template <class Fit>
int splits(int M, int K, int N, Fit fit) {
  const int t = tiles(M, N), lo = min_splits(K);
  for (int s = imin(kMaxCluster, products(K)); s > lo; --s) {
    const int S = trim(K, s);
    if (S > lo && t * S <= kSMs && fit(S, split_products(K, S)) >= t) return S;
  }
  return trim(K, lo);
}
OV_HD constexpr int blocks(int M, int N, int S) { return tiles(M, N) * S; }

}  // namespace ovp
