// The plan of row 1's launches (fused_decode.cu) that the host needs: the
// GEMV tiles, splits (clusters) and shared memory, and the attention
// launch's shared memory and window.  Plain C++ with no CUDA header, so the
// one definition is compiled into the kernels by nvcc and, for the CPU
// tests (tests/test_torch_fused_plan.py), by a host compiler.
//
// Nothing here depends on the depth L: a whole-depth step and the chain
// of its one-layer steps split every product the same way, so they give
// the same bits.

#pragma once

#ifdef __CUDACC__
#define FD_HD __host__ __device__
#else
#define FD_HD
#endif

namespace fdp {

// ---------------------------------------------------------------------------
// GEMVs: y (B x N) = x (B x K) . W (K x N), W int8 or packed int4 (K/2 rows)
// ---------------------------------------------------------------------------

constexpr int kBT = 16;          // batch rows of a tile: the m16 of mma.sync m16n8k16
constexpr int kNT = 32;          // weight columns of a block: 8 lanes x 4 bytes
constexpr int kKStep = 16;       // packed weight rows of one mma k-step
constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kMinBlocks = 132;  // the H100's SMs: each GEMV spreads over at least as many blocks
constexpr int kMaxSplits = 16;   // splits of K: one cluster (16 needs the non-portable opt-in)
constexpr int kMaxRows = 256;    // packed weight rows staged at once (shared memory)
// A staged weight row: 32 bytes and 16 of padding.  A lane reads 4 bytes
// of rows 2t, 2t + 1, 2t + 8 and 2t + 9 of a k-step; at a 48-byte stride
// (12 banks) each of the four reads of a warp falls on 32 distinct banks.
constexpr int kWRowBytes = kNT + 16;
// A staged activation row (bf16): kMaxRows + 8 elements, 132 words, 4
// banks mod 32, so the 8 rows of an ldmatrix phase fall on distinct banks.
constexpr int kXRow = kMaxRows + 8;

FD_HD constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
FD_HD constexpr int imin(int a, int b) { return a < b ? a : b; }
FD_HD constexpr int imax(int a, int b) { return a > b ? a : b; }
FD_HD constexpr int batch_tiles(int B) { return ceil_div(B, kBT); }
FD_HD constexpr int col_tiles(int N) { return N / kNT; }
FD_HD constexpr int packed_rows(int K, int int4) { return int4 ? K / 2 : K; }

FD_HD constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// Packed rows of one split: K is cut into the least power of two of
// splits that gives kMinBlocks blocks (more where a split would pass
// kMaxRows, at most kMaxSplits), in whole k-steps.  Past kMaxSplits x
// kMaxRows packed rows a split holds more than kMaxRows, and its block
// walks them kMaxRows at a time.
FD_HD constexpr int split_rows(int Kp, int N, int B) {
  return imax(kKStep, ceil_div(ceil_div(Kp, imin(kMaxSplits, imax(pow2_at_least(ceil_div(
      kMinBlocks, col_tiles(N) * batch_tiles(B))), ceil_div(Kp, kMaxRows)))), kKStep) * kKStep);
}

FD_HD constexpr int splits(int Kp, int N, int B) { return ceil_div(Kp, split_rows(Kp, N, B)); }

// a GEMV block's shared memory (GemvSmem): weights, activations (two
// halves for int4), the warps' sums, the split's sum, the rows' LayerNorm
FD_HD constexpr int gemv_smem(int int4) {
  return kMaxRows * kWRowBytes + (int4 ? 2 : 1) * kBT * kXRow * 2 +
         kGemvWarps * kBT * (kNT + 1) * 4 + kBT * kNT * 4 + kBT * 8;
}

// The step's four products, in launch order: QKV (D x 3HD), out (HD x D),
// FF1 (D x F), FF2 (F x D).
FD_HD constexpr int gemv_k(int i, int D, int HD, int F) {
  return i == 0 ? D : i == 1 ? HD : i == 2 ? D : F;
}
FD_HD constexpr int gemv_n(int i, int D, int HD, int F) {
  return i == 0 ? 3 * HD : i == 1 ? D : i == 2 ? F : D;
}

// Whether the GEMVs take these widths: whole k-steps and column tiles.
FD_HD constexpr bool gemv_fits(int D, int HD, int F, int int4) {
  bool ok = true;
  for (int i = 0; i < 4; ++i) {
    const int Kp = packed_rows(gemv_k(i, D, HD, F), int4), N = gemv_n(i, D, HD, F);
    ok = ok && Kp % kKStep == 0 && N % kNT == 0;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// the attention launch: FAVOR blocks (batch x global head), then local
// blocks (batch x local head)
// ---------------------------------------------------------------------------

constexpr int kAttnThreads = 256;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take on Hopper
constexpr int kRedFloats = 32;    // one float per warp of a block reduction
constexpr int kPartFloats = kAttnThreads * 8;  // per-group sums before the fixed-order fold

// A staged row (an S row of a head, a ring slot of a head): padded by 16
// bytes, so 8 consecutive rows read at one offset fall on distinct banks.
FD_HD constexpr int row_bytes(int dh, int elem) { return dh * elem + 16; }

// FAVOR: the head's S slice (m rows of dh bf16), then q, k, v, q', k',
// the reduction slots, the numerator's group sums and the head's z row.
// (Staging the layer's projT too, 64 KB at the paper shape, measured
// slower: the launch then leaves no room on an SM for the next product's
// blocks to start early.)
FD_HD constexpr int favor_smem(int dh, int m) {
  return m * row_bytes(dh, 2) + 4 * (3 * dh + 3 * m + kRedFloats + kPartFloats);
}

// The slots of a head's ring that a step reads: positions t − W < p < t
// that the ring still holds (R back), at most min(W − 1, R).
FD_HD constexpr int window_rows(int R, int W) { return imax(0, imin(W - 1, R)); }

// The first position the step at t reads: t − W < p, and p ≥ t − R (the
// ring still holds it).  The window is p0 .. t − 1, in slots p mod R.
FD_HD constexpr int window_first(int t, int R, int W) { return imax(0, imax(t - W + 1, t - R)); }

// local: staged K and V rows, then q, k, v, the un-rotated q and k, the
// rotary's cos and sin, the window's scores and its K and V scales, the
// reduction slots and the P·V group sums
FD_HD constexpr int local_fixed(int dh, int R, int W) {
  return 4 * (7 * dh + 3 * imax(1, window_rows(R, W)) + kRedFloats + kPartFloats);
}

// Slots one staging buffer holds: the whole window where K and V fit side
// by side, else as many as fit (the kernel then streams the window in
// chunks, K for the scores, then V for P·V).
FD_HD constexpr int local_cap(int dh, int R, int W, int elem) {
  return imax(1, imin(imax(1, window_rows(R, W)),
                      (kSmemMax - local_fixed(dh, R, W)) / (2 * row_bytes(dh, elem))));
}

FD_HD constexpr int local_smem(int dh, int R, int W, int elem) {
  return local_fixed(dh, R, W) + 2 * local_cap(dh, R, W, elem) * row_bytes(dh, elem);
}

// dynamic shared memory of the attention launch (elem: ring bytes; lh 0:
// no local blocks)
FD_HD constexpr int attn_smem(int dh, int m, int lh, int R, int W, int elem) {
  return imax(favor_smem(dh, m), lh > 0 ? local_smem(dh, R, W, elem) : 0);
}

}  // namespace fdp
