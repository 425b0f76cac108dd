// The plan of the nearest-codeword kernels (vq_argmin.cu) that the host
// needs: the padded width and where x's fragments live, the code tile and
// the shared-memory layout, the grid and its clusters, the split of the
// codebook over a cluster, and the statistics pass's blocks.  Plain C++
// with no CUDA header, so the one definition is compiled into the kernels
// by nvcc and, for the CPU tests (tests/test_torch_vq_plan.py), by a host
// compiler.
//
// The argmin: a block is two warpgroups on 128 rows of x (64 a
// warpgroup, 16 a warp) and one split of the codebook; the splits of a
// row tile are one thread-block cluster and merge their (distance, index)
// per row through distributed shared memory.  A block walks its split in
// code tiles of ct codes: f32 rows staged by cp.async into a 2-slot raw
// ring, then split in one pass into TF32 big and small tiles in wgmma's
// K-major 128-byte swizzle, with ‖w‖² summed once a staged codeword; each
// warpgroup's product of a tile is 3 wgmma m64n{ct}k8 a k-step.

#pragma once

#ifdef __CUDACC__
#define VQ_HD __host__ __device__
#else
#define VQ_HD
#endif

namespace vqp {

constexpr int kWarps = 8;              // warps of an argmin block: two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;     // rows of x a block: 16 a warp
constexpr int kMaxD = 256;             // the widest row the kernels take
constexpr int kMinBlocks = 132;        // the H100's SMs
constexpr int kSmemMax = 232448;       // dynamic shared memory a block may take
constexpr int kAtom = 128;             // bytes of a swizzle atom's row: 32 TF32 values
// The splits of the codebook, at most one portable cluster; and the codes
// of a staged tile (the products' N), at most.  A tile of 64 keeps the D
// <= 32 instantiation within 128 registers and 113 KB, two blocks an SM,
// so that every cluster of 4 the paper shape launches fits the card at
// once (with 128, 30 of 33 do).
constexpr int kMaxCluster = 8;
constexpr int kMaxCodeTile = 64;
// statistics: a warp owns kStatCodesPerWarp codewords, walks the indices
// (staged kIdxChunk at a time) in row order, kStatScan groups of 32 a
// step, lists the rows that chose each codeword (up to kStatList at a
// time), then adds them kStatBatch rows at a time (their loads in flight
// together, a row a lane), in row order
constexpr int kStatWarps = 8;
constexpr int kStatCodesPerWarp = 2;
constexpr int kStatCodes = kStatWarps * kStatCodesPerWarp;
constexpr int kIdxChunk = 4096;
constexpr int kStatList = 256;
constexpr int kStatBatch = 32;
constexpr int kStatScan = 8;  // groups of 32 indices a warp's scan step ballots

VQ_HD constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
VQ_HD constexpr int round_up(int a, int m) { return ceil_div(a, m) * m; }
VQ_HD constexpr int imin(int a, int b) { return a < b ? a : b; }
VQ_HD constexpr int imax(int a, int b) { return a > b ? a : b; }

VQ_HD constexpr bool width_ok(int D) { return D >= 1 && D <= kMaxD; }

// the padded width: 32, 64, 128 or 256 (whole swizzle atoms; zeros past D
// add nothing to a product or to ‖w‖²)
VQ_HD constexpr int padded_d(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }
VQ_HD constexpr int k_steps(int D) { return padded_d(D) / 8; }
// k-steps of 8 that a warp holds x's split fragments for, in registers
// for the whole walk (the kernel's instantiations 4 and 8), or 0 for rows
// wider than 64, whose fragments each k-step reads again (from L1)
VQ_HD constexpr int reg_steps(int D) { return padded_d(D) <= 64 ? k_steps(D) : 0; }

// A code's staged f32 row: padded_d and 4 more floats (the split pass's
// 16-byte loads of neighbouring codes fall on other banks).
VQ_HD constexpr int raw_row_floats(int D) { return padded_d(D) + 4; }
VQ_HD constexpr int raw_row_bytes(int D) { return 4 * raw_row_floats(D); }
// One split tile (big or small) of ct codes: K-major in wgmma's 128-byte
// swizzle, atom columns of 32 TF32 values (one a 32 columns of the row)
// one after the other, each ct rows of 128 bytes with 16-byte chunk c of
// row r at c ^ (r % 8); 1024-byte aligned.  Chunk h of a k-step holds its
// k slots 4h to 4h + 3 (k_column).
// the column of the padded row that k slot j (0-7) of k-step ks takes:
// lane t's slots t and t + 4 are the neighbouring columns 2t and 2t + 1
// (one 8-byte load of x), in A as in B, so a split tile's first chunk of
// a k-step holds its columns 0, 2, 4, 6 and the second 1, 3, 5, 7
VQ_HD constexpr int k_column(int ks, int j) { return 8 * ks + 2 * (j % 4) + j / 4; }
VQ_HD constexpr int split_tile_bytes(int D, int ct) { return ct * 4 * padded_d(D); }
// the byte of (code r, k-step ks, chunk h of the two) in a split tile
VQ_HD constexpr int split_offset(int ct, int r, int ks, int h) {
  return (ks / 4) * ct * kAtom + r * kAtom + (((2 * (ks % 4) + h) ^ (r % 8)) * 16);
}

// Shared memory of an argmin block for a code tile of ct codes: the split
// ring (2 slots of a big and a small tile) first, then the raw ring (2
// slots), ‖w‖² of both split slots, and the per-row (distance, index)
// that the cluster merges.
VQ_HD constexpr int argmin_smem_for(int D, int ct) {
  return 4 * split_tile_bytes(D, ct) + 2 * ct * raw_row_bytes(D) + 2 * ct * 4 + kRows * 8;
}
// the code tile: 64 or 32 codes (the products' N), the largest whose
// block fits
VQ_HD constexpr int code_tile(int D) {
  int ct = kMaxCodeTile;
  while (ct > 32 && argmin_smem_for(D, ct) > kSmemMax) ct /= 2;
  return ct;
}
VQ_HD constexpr int argmin_smem(int D) { return argmin_smem_for(D, code_tile(D)); }
// the split pass: an item is (code, k-step), k_steps neighbouring threads
// a code (a power of two up to 32: a shuffle tree for ‖w‖²), each
// splitting its k-step's 8 columns
VQ_HD constexpr int split_items(int D) { return code_tile(D) * k_steps(D); }

// ---------------------------------------------------------------------------
// the grid: row tiles of kRows, each split over a cluster of blocks
// ---------------------------------------------------------------------------

VQ_HD constexpr int row_tiles(int N) { return ceil_div(N, kRows); }
// splits asked for: as many as fill the SMs once (at most a cluster of
// kMaxCluster), and no split of fewer than 8 codes
VQ_HD constexpr int splits_wanted(int N, int K) {
  return imax(1, imin(imin(kMaxCluster, kMinBlocks / row_tiles(N)), ceil_div(K, 8)));
}
// codes of a split: whole n8 tiles; the last split takes the rest
VQ_HD constexpr int split_codes(int N, int K) {
  return round_up(ceil_div(K, splits_wanted(N, K)), 8);
}
VQ_HD constexpr int splits(int N, int K) { return ceil_div(K, split_codes(N, K)); }
VQ_HD constexpr int split_begin(int N, int K, int s) { return s * split_codes(N, K); }
VQ_HD constexpr int split_end(int N, int K, int s) {
  return imin(K, (s + 1) * split_codes(N, K));
}
// block b of the grid: split b % splits (its rank in the cluster), row
// tile b / splits
VQ_HD constexpr int argmin_blocks(int N, int K) { return splits(N, K) * row_tiles(N); }
// the rows of its tile that cluster rank r merges and writes: r, r + S, ...
// (thread j of the block takes the j-th)
VQ_HD constexpr int merge_rows(int N, int K, int r) {
  return ceil_div(kRows - r, splits(N, K));
}
VQ_HD constexpr int merge_row(int N, int K, int r, int j) { return r + splits(N, K) * j; }

// ---------------------------------------------------------------------------
// the statistics pass: a block per kStatCodes codewords
// ---------------------------------------------------------------------------

VQ_HD constexpr int stat_blocks(int K) { return ceil_div(K, kStatCodes); }
VQ_HD constexpr int idx_chunks(int N) { return ceil_div(N, kIdxChunk); }
// its static shared memory: the staged indices, each warp's row lists and
// its codewords' running Σx
constexpr int kStatSmem =
    4 * (kIdxChunk + kStatWarps * kStatCodesPerWarp * (kStatList + kMaxD));

}  // namespace vqp
