// The plan of row 5's chunk-parallel route (favor_core.cuh) that the host
// needs: the route gate, the chunk walk and its 64-row sub-tiles, the
// order of the state scan, the workspace layout and every launch's grid
// and dynamic shared memory.  Plain C++ with no CUDA header, so the one
// definition is compiled into the kernels by nvcc and, for the CPU tests
// (tests/test_torch_favor_plan.py), by a host compiler.

#pragma once

#ifdef __CUDACC__
#define FP_HD __host__ __device__
#else
#define FP_HD
#endif

namespace fp {

constexpr int kSub = 64;       // rows of a sub-tile: one warpgroup, 16 rows a warp
constexpr int kThreads = 128;  // a block of every launch but the scan
constexpr int kScanThreads = 256;
constexpr int kDP = 64;        // the head dim, zero-padded: the route takes d <= 64
constexpr int kMaxM = 256;     // the widest feature map the route takes
constexpr int kSmemPerBlock = 232448;  // the H100's largest dynamic shared memory a block
constexpr int kSmemPerSM = 233472;     // the SM's 228 KB, of which each block also holds 1 KB
constexpr int kReservedPerBlock = 1024;

// The chunk-parallel route: d a multiple of 8 up to 64 (rows of 16-byte
// multiples for cp.async, one padded width), m up to 256, any chunk, and
// 2- or 4-byte inputs (bf16 on the tensor cores, f32 on FMAs).  Anything
// else takes the earlier one-block-per-(batch, head) kernels.
FP_HD constexpr bool tile_route(int d, int m, int chunk, int elem) {
  return d >= 8 && d <= kDP && d % 8 == 0 && m >= 1 && m <= kMaxM && chunk >= 1 &&
         (elem == 2 || elem == 4);
}

// features padded to 64 or 256: the width a kernel is instantiated at
// (two widths keep the build short; m 128, the validation prior's, runs
// at 256)
FP_HD constexpr int padded_m(int m) { return m <= 64 ? 64 : 256; }

// ---------------------------------------------------------------------------
// the chunk walk
// ---------------------------------------------------------------------------

FP_HD constexpr int chunks(int n, int chunk) { return (n + chunk - 1) / chunk; }

// rows of chunk c (the last one ragged)
FP_HD constexpr int chunk_rows(int c, int n, int chunk) {
  return n - c * chunk < chunk ? n - c * chunk : chunk;
}

// 64-row sub-tiles of a full chunk (the consumers' grid.x)
FP_HD constexpr int subs(int chunk) { return (chunk + kSub - 1) / kSub; }

// rows of sub-tile s of chunk c (0 past the chunk's end: that block returns)
FP_HD constexpr int sub_rows(int c, int s, int n, int chunk) {
  return chunk_rows(c, n, chunk) - s * kSub <= 0 ? 0
         : chunk_rows(c, n, chunk) - s * kSub < kSub ? chunk_rows(c, n, chunk) - s * kSub
                                                     : kSub;
}

// ---------------------------------------------------------------------------
// the state scan
// ---------------------------------------------------------------------------

// Direction 0 carries (S, z) forward: chunk c reads the sum of chunks 0 ..
// c − 1.  Direction 1 carries (dS, dz) backward: chunk c reads the sum of
// chunks c + 1 .. nc − 1.  The scan visits the chunks in this order and
// hands each the sum of those it visited before, ((0 + Δ0) + Δ1) + …, the
// order in which the sequential carry of the TPU kernel adds them.
FP_HD constexpr int scan_chunk(int step, int nc, int dir) { return dir ? nc - 1 - step : step; }

// floats of one chunk's state: S (or dS) as [mp][kDP], then z (or dz) [mp]
FP_HD constexpr int state_floats(int mp) { return mp * kDP + mp; }

// ---------------------------------------------------------------------------
// workspace (bytes, each array 256-byte aligned)
// ---------------------------------------------------------------------------

FP_HD constexpr long long align256(long long x) { return (x + 255) / 256 * 256; }

enum { kKC = 0, kQC, kDN, kGD, kDelta0, kDelta1, kST0, kST1, kZF0, kZF1, kArrays };

// Arrays of the workspace of one call; bwd adds the query side and the
// reverse direction.
//   kKC   rnd(φ(k)) (T) [bh][n][mp]      kQC  rnd(φ(q)) (T) [bh][n][mp]
//   kDN   rnd(g / den) (T) [bh][n][kDP]  kGD  −(g·out) / den (f32) [bh][n]
//   kDelta0/1  each sub-tile's part of its chunk's own state (f32)
//              [bh][nc][subs][state_floats]
//   kST0/1     rnd(S) or rnd(dS) scanned (T) [bh][nc][mp][kDP]
//   kZF0/1     z or dz scanned (f32) [bh][nc][mp]
// An array a call does not use has size 0.
FP_HD constexpr long long array_bytes(int a, int bh, int n, int chunk, int mp, int elem,
                                      bool bwd) {
  const long long rows = 1LL * bh * n, nc = 1LL * bh * chunks(n, chunk);
  const long long parts = nc * subs(chunk);
  return a == kKC ? rows * mp * elem
         : a == kQC   ? (bwd ? rows * mp * elem : 0)
         : a == kDN   ? (bwd ? rows * kDP * elem : 0)
         : a == kGD   ? (bwd ? rows * 4 : 0)
         : a == kDelta0 ? parts * state_floats(mp) * 4
         : a == kDelta1 ? (bwd ? parts * state_floats(mp) * 4 : 0)
         : a == kST0    ? nc * mp * kDP * elem
         : a == kST1    ? (bwd ? nc * mp * kDP * elem : 0)
         : a == kZF0    ? nc * mp * 4
         : a == kZF1    ? (bwd ? nc * mp * 4 : 0)
                        : 0;
}

FP_HD constexpr long long array_offset(int a, int bh, int n, int chunk, int mp, int elem,
                                       bool bwd) {
  return a == 0 ? 0
                : array_offset(a - 1, bh, n, chunk, mp, elem, bwd) +
                      align256(array_bytes(a - 1, bh, n, chunk, mp, elem, bwd));
}

FP_HD constexpr long long work_bytes(int bh, int n, int chunk, int mp, int elem, bool bwd) {
  return array_offset(kArrays, bh, n, chunk, mp, elem, bwd);
}

// ---------------------------------------------------------------------------
// launches: grids and dynamic shared memory
// ---------------------------------------------------------------------------

// kState: each sub-tile's part of its chunk's own (ΔS, Δz) (and in the
// backward, in blocks of their own, (ΔdS, Δdz)), and the features (and
// dnum, gd) of its rows for the consumers; kScan; the consumers kFwd (out,
// den), kDq and kDkv.  `dirs` is 1 for a forward call, 2 for a backward.
enum { kState = 0, kScan, kFwd, kDq, kDkv, kKinds };

// launches of one call: forward state, scan, consumer; backward state,
// scan (both directions), dq, dk/dv
constexpr int kFwdLaunches = 3;
constexpr int kBwdLaunches = 4;

struct Grid {
  int x, y, z;
};

FP_HD constexpr Grid grid(int kind, int bh, int n, int chunk, int mp, int dirs) {
  return kind == kState ? Grid{dirs * subs(chunk), chunks(n, chunk), bh}
         : kind == kScan ? Grid{(state_floats(mp) / 4 + kScanThreads - 1) / kScanThreads, bh, dirs}
                         : Grid{subs(chunk), chunks(n, chunk), bh};
}

FP_HD constexpr long long blocks(int kind, int bh, int n, int chunk, int mp, int dirs) {
  return 1LL * grid(kind, bh, n, chunk, mp, dirs).x * grid(kind, bh, n, chunk, mp, dirs).y *
         grid(kind, bh, n, chunk, mp, dirs).z;
}

// row stride (elements of `elem` bytes) of a staged tile of `cols` columns:
// 16 bytes of padding, so the 8 rows an ldmatrix phase reads fall on
// distinct banks
FP_HD constexpr int row_ld(int elem, int cols) { return cols + 16 / elem; }

FP_HD constexpr int tile_bytes(int elem, int rows, int cols) {
  return rows * row_ld(elem, cols) * elem;
}

FP_HD constexpr int align128(int x) { return (x + 127) / 128 * 128; }
FP_HD constexpr int max2(int a, int b) { return a > b ? a : b; }

// Shared-memory regions of each kernel, in bytes, in order (each
// 128-byte aligned); a region holds one array, then another once the
// first is dead.
//   kState  P [mp][64]; X (k, or q, scaled) [64][64]; Y (v, or g, then
//           dnum) [64][64]; XC (kc, or qc) [64][mp]; f32 diag, gd, den
//           [64] each, column sums [4][mp]; f32 out [64][64] (queries)
//   kFwd    P, then S [mp][64]; QC own [64][mp]; KC [64][mp]; q, then v
//           [64][64]; f32 diag [64]
//   kDq     P [mp][64]; KC, then S max([mp][64], [64][mp]); V [64][64]; Q
//           [64][64]; DN [64][64]; f32 diag, gd [64] each, z [mp]
//   kDkv    QC, then dS, then P max([64][mp], [mp][64]); KC own [64][mp];
//           V own [64][64]; DN, then K [64][64]; f32 gd, diag [64] each,
//           dz [mp]
constexpr int kRegions = 6;

FP_HD constexpr int region_bytes(int kind, int r, int elem, int mp) {
  return kind == kState ? (r == 0   ? tile_bytes(elem, mp, kDP)
                           : r == 1 ? tile_bytes(elem, kSub, kDP)
                           : r == 2 ? tile_bytes(elem, kSub, kDP)
                           : r == 3 ? tile_bytes(elem, kSub, mp)
                           : r == 4 ? 4 * (3 * kSub + 4 * mp)
                           : r == 5 ? tile_bytes(4, kSub, kDP)
                                    : 0)
         : kind == kFwd ? (r == 0   ? tile_bytes(elem, mp, kDP)
                           : r == 1 ? tile_bytes(elem, kSub, mp)
                           : r == 2 ? tile_bytes(elem, kSub, mp)
                           : r == 3 ? tile_bytes(elem, kSub, kDP)
                           : r == 4 ? 4 * kSub
                                    : 0)
         : kind == kDq ? (r == 0   ? tile_bytes(elem, mp, kDP)
                          : r == 1 ? max2(tile_bytes(elem, mp, kDP), tile_bytes(elem, kSub, mp))
                          : r == 2 ? tile_bytes(elem, kSub, kDP)
                          : r == 3 ? tile_bytes(elem, kSub, kDP)
                          : r == 4 ? tile_bytes(elem, kSub, kDP)
                          : r == 5 ? 4 * (2 * kSub + mp)
                                   : 0)
         : kind == kDkv ? (r == 0   ? max2(tile_bytes(elem, kSub, mp), tile_bytes(elem, mp, kDP))
                           : r == 1 ? tile_bytes(elem, kSub, mp)
                           : r == 2 ? tile_bytes(elem, kSub, kDP)
                           : r == 3 ? tile_bytes(elem, kSub, kDP)
                           : r == 4 ? 4 * (2 * kSub + mp)
                                    : 0)
                        : 0;
}

FP_HD constexpr int region_offset(int kind, int r, int elem, int mp) {
  return r == 0 ? 0 : region_offset(kind, r - 1, elem, mp) + align128(region_bytes(kind, r - 1, elem, mp));
}

FP_HD constexpr int smem_bytes(int kind, int elem, int mp) {
  return kind == kScan ? 0 : region_offset(kind, kRegions, elem, mp);
}

// the largest launch of the route at this width
FP_HD constexpr int route_smem_bytes(int elem, int mp) {
  return max2(max2(smem_bytes(kState, elem, mp), smem_bytes(kFwd, elem, mp)),
              max2(smem_bytes(kDq, elem, mp), smem_bytes(kDkv, elem, mp)));
}

// blocks of a launch resident on one SM, as shared memory allows (the
// scan takes none: 0)
FP_HD constexpr int blocks_per_sm(int kind, int elem, int mp) {
  return kind == kScan ? 0 : kSmemPerSM / (smem_bytes(kind, elem, mp) + kReservedPerBlock);
}

}  // namespace fp
