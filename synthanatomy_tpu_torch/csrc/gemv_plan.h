// The plan of the weight-streaming GEMVs (weight_gemv.cuh, launched by
// int8_matmul.cu and weight_stream.cu) that the host needs: the warp's
// column strip and weight ring, the m16 tiles a block carries, the grids,
// splits and clusters, each launch's shared memory, and the weight bytes
// a call reads.  Plain C++ with no CUDA header, so the one definition is
// compiled into the kernels by nvcc and, for the CPU tests
// (tests/test_torch_gemv_plan.py), by a host compiler.
//
// Both kernels compute y = bf16(x) · W over int8 weights W (Kp = K rows)
// or nibble-packed int4 weights (Kp = K/2 rows, byte k holding rows k and
// k + K/2), on mma.sync m16n8k16 with M = the rows of x.  A warp owns a
// strip of 32 weight columns; the warps on neighbouring strips (one for
// the matmul, a fold group's four for the stream) stream their rows
// through one ring; the x rows a block carries (up to kMaxTiles m16
// tiles) share every weight it stages, so a weight byte is read once a
// call for up to 16 · kMaxTiles rows of x, and once for each further
// group of that many.

#pragma once

#ifdef __CUDACC__
#define GV_HD __host__ __device__
#else
#define GV_HD
#endif

namespace gvp {

constexpr int kStrip = 32;      // weight columns of a warp: 8 lanes x 4 bytes
constexpr int kKStep = 16;      // packed rows of one mma k-step
constexpr int kChunk = 32;      // packed rows of one ring slot (2 k-steps)
constexpr int kStages = 4;      // slots of a ring
constexpr int kMaxTiles = 4;    // m16 tiles of x a block carries: 64 rows
constexpr int kXPiece = 512;    // columns of x (of K) staged at once
constexpr int kXPad = 8;        // bf16 padding of a staged x row (4 banks)
constexpr int kMinBlocks = 132; // the H100's SMs
constexpr int kMaxSplits = 16;  // splits of K: one cluster (16 needs the non-portable opt-in)
constexpr int kGroupStrips = 4;          // strips of a fold group a stream block takes
constexpr int kStreamCols = kGroupStrips * kStrip;  // output columns of a stream block
constexpr int kStreamWarps = 8;          // warps of a stream block, at most
constexpr int kSmemMax = 232448;         // dynamic shared memory a block may take

GV_HD constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
GV_HD constexpr int imin(int a, int b) { return a < b ? a : b; }
GV_HD constexpr int imax(int a, int b) { return a > b ? a : b; }
GV_HD constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// A ring staged for sw strips side by side: a row's sw · 32 bytes and 16
// of padding.  A lane reads 4 bytes of rows 2t, 2t + 1, 2t + 8 and 2t + 9
// of a k-step in its warp's strip; at a stride of 8 sw + 4 words each of
// the four reads of a warp falls on 32 distinct banks.
GV_HD constexpr int ring_row_bytes(int sw) { return sw * kStrip + 16; }
GV_HD constexpr int ring_slot_bytes(int sw) { return kChunk * ring_row_bytes(sw); }
GV_HD constexpr int ring_bytes(int sw) { return kStages * ring_slot_bytes(sw); }

GV_HD constexpr int packed_rows(int K, int int4) { return int4 ? K / 2 : K; }
// x halves a packed row reads: int4's low nibble takes x[:, k], its high
// nibble x[:, k + K/2]
GV_HD constexpr int halves(int int4) { return int4 ? 2 : 1; }

// m16 tiles a block carries for R rows of x (1, 2 or 4: the kernels'
// instantiations), and the groups of 16 · tiles rows the grid walks
GV_HD constexpr int m_tiles(int R) { return R <= 16 ? 1 : R <= 32 ? 2 : kMaxTiles; }
GV_HD constexpr int row_groups(int R) { return imax(1, ceil_div(R, 16 * m_tiles(R))); }

// packed rows of x staged at once (kXPiece columns of K in all halves)
GV_HD constexpr int piece_rows(int int4) { return kXPiece / halves(int4); }

// a staged x row of `rows` packed columns: whole ring chunks (the core
// runs every k-step of a chunk) and the padding, in bf16 elements
GV_HD constexpr int x_row(int rows) { return ceil_div(rows, kChunk) * kChunk + kXPad; }
// a staged x piece: every half, 16 · tiles rows
GV_HD constexpr int x_bytes(int tiles, int rows, int int4) {
  return halves(int4) * 16 * tiles * x_row(rows) * 2;
}

// ---------------------------------------------------------------------------
// int8_matmul / int4_matmul: out (R, N) = (bf16(x) · W) × scale, one warp a
// block, blocks (strips of N, splits of K, row groups); the splits of a
// strip are one cluster and add each other's sums in split order
// ---------------------------------------------------------------------------

GV_HD constexpr int strips(int N) { return ceil_div(N, kStrip); }
// columns of strip x inside N (16-byte copies of whole 16-column halves
// where N % 16 == 0)
GV_HD constexpr int strip_cols(int N, int x) { return imin(kStrip, N - kStrip * x); }

// Packed rows of one split: Kp is cut into the least power of two of
// splits that gives kMinBlocks blocks (at most kMaxSplits), in whole
// k-steps.
GV_HD constexpr int split_rows(int Kp, int N, int R) {
  return ceil_div(ceil_div(Kp, imin(kMaxSplits, pow2_at_least(ceil_div(
      kMinBlocks, strips(N) * row_groups(R))))), kKStep) * kKStep;
}
GV_HD constexpr int splits(int Kp, int N, int R) {
  return imax(1, ceil_div(Kp, split_rows(Kp, N, R)));
}
// the packed rows split y reads: [split_begin, split_begin + split_count)
GV_HD constexpr int split_begin(int Kp, int N, int R, int y) { return y * split_rows(Kp, N, R); }
GV_HD constexpr int split_count(int Kp, int N, int R, int y) {
  return imax(0, imin(split_rows(Kp, N, R), Kp - split_begin(Kp, N, R, y)));
}
GV_HD constexpr int matmul_blocks(int Kp, int N, int R) {
  return strips(N) * splits(Kp, N, R) * row_groups(R);
}

// packed rows of x a matmul block stages at once: the split's rows or a
// piece of them (the same for every block of the launch, so the split
// sums lie at one offset in every block's shared memory)
GV_HD constexpr int matmul_x_rows(int Kp, int N, int R, int int4) {
  return imin(split_rows(Kp, N, R), piece_rows(int4));
}

// a matmul block's shared memory: its warp's ring, its x piece, the
// split's unscaled sums (one per half for int4, 16 · tiles x 32 f32 each)
// that the cluster reads
GV_HD constexpr int matmul_smem(int Kp, int N, int R, int int4) {
  return ring_bytes(1) + x_bytes(m_tiles(R), matmul_x_rows(Kp, N, R, int4), int4) +
         halves(int4) * 16 * m_tiles(R) * kStrip * 4;
}

// ---------------------------------------------------------------------------
// weight_stream: partial[i] (B, K) = fold(bf16(x) · W_i · s_i), the fold
// summing the N/K column groups; a block per (128 output columns, layer
// i, row group), its warps on the strips g·K + c0 + 32h of every group g
// (each row's 128 bytes of a group read by four warps side by side)
// ---------------------------------------------------------------------------

GV_HD constexpr int stream_groups(int K, int N) { return N / K; }
GV_HD constexpr int stream_strips(int K, int N) { return kGroupStrips * stream_groups(K, N); }
GV_HD constexpr int stream_warps(int K, int N) {
  return imin(kStreamWarps, stream_strips(K, N));
}
GV_HD constexpr int stream_col_tiles(int K) { return ceil_div(K, kStreamCols); }
GV_HD constexpr int stream_blocks(int L, int B, int K) {
  return stream_col_tiles(K) * L * row_groups(B);
}
// The warps of a block walk the fold groups in rounds: warp w takes strip
// h = w % 4 of group g = w / 4 + round · warps / 4, so a round holds whole
// groups and the fold adds them in g order.
GV_HD constexpr int stream_rounds(int K, int N) {
  return ceil_div(stream_strips(K, N), stream_warps(K, N));
}
// group g of column tile c: weight columns g·K + 128c onward, and how
// many of them lie inside group g (the rest belong to group g + 1, whose
// own block reads them: they are not read here)
GV_HD constexpr int stream_group_col0(int K, int c, int g) { return g * K + kStreamCols * c; }
GV_HD constexpr int stream_group_cols(int K, int c) {
  return imax(0, imin(kStreamCols, K - kStreamCols * c));
}

// a stream block's shared memory: a ring for each group of a round (the
// group's kGroupStrips warps share it), its x piece, the fold's sum (16 ·
// tiles x 128 f32)
GV_HD constexpr int stream_smem(int B, int K, int N, int int4) {
  return stream_warps(K, N) / kGroupStrips * ring_bytes(kGroupStrips) +
         x_bytes(m_tiles(B), imin(packed_rows(K, int4), piece_rows(int4)), int4) +
         16 * m_tiles(B) * kStreamCols * 4;
}

// ---------------------------------------------------------------------------
// what a call reads of the weights, block by block as the kernels walk
// them: every block stages each byte of its strips' rows once, for all
// the rows of x it carries
// ---------------------------------------------------------------------------

GV_HD constexpr long long matmul_weight_reads(int K, int N, int R, int int4) {
  const int Kp = packed_rows(K, int4);
  long long n = 0;
  for (int z = 0; z < row_groups(R); ++z)
    for (int y = 0; y < splits(Kp, N, R); ++y)
      for (int x = 0; x < strips(N); ++x)
        n += (long long)split_count(Kp, N, R, y) * strip_cols(N, x);
  return n;
}

// one layer (the launch walks L of them the same way)
GV_HD constexpr long long stream_weight_reads(int B, int K, int N, int int4) {
  long long n = 0;
  for (int z = 0; z < row_groups(B); ++z)
    for (int c = 0; c < stream_col_tiles(K); ++c)
      for (int g = 0; g < stream_groups(K, N); ++g)
        n += (long long)packed_rows(K, int4) * stream_group_cols(K, c);
  return n;
}

}  // namespace gvp
