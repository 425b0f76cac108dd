// Block-wide weight-streaming GEMV for the decode regime (few rows of x,
// int8 or nibble-packed int4 weights), shared by int8_matmul.cu and
// weight_stream.cu.
//
// res[a][r][jj] = Σ_k bf16(x[r, k]) · w[k, j0 + jj] over one tile of
// kTileN = 64 output columns and up to RT rows of x.  int8 weights give
// one sum (a = 0).  Packed int4 weights (K/2, N), byte k holding row k in
// the low nibble and row k + K/2 in the high nibble, give two: a = 0 over
// the low rows against x[:, :K/2] and a = 1 over the high rows against
// x[:, K/2:], so the caller applies one scale per half or one for both.
//
// Work split: 256 threads = 64 k-slices × 4 groups of 16 columns.  A
// thread walks rows k = slice, slice + 64, ... and reads its 16 weights
// of a row with one 16-byte load where the layout allows it (VEC), so a
// warp reads 8 rows × 64 contiguous bytes.  Weights convert to f32 in
// registers (exact in bf16); x is rounded to bf16, so each product is the
// TPU's bf16 product, exact in f32, summed in f32.  The 8 slices of a warp
// meet by xor shuffles and the 8 warps in shared memory, in a fixed
// order: two runs give identical bits.  No tensor cores: at R ≤ 16 rows
// the work is a few FMAs per weight byte, far below the ~295 operations
// per byte where the tensor cores, not the memory, would be the limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sa_gemv {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                    // 16-column groups of a tile
constexpr int kTileN = 16 * kGroups;          // 64 output columns
constexpr int kSlices = kThreads / kGroups;   // 64 k-slices
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 8;                      // NSUM · RT for both formats
constexpr int kRedFloats = kWarps * kSums * kTileN;
constexpr int kResFloats = kSums * kTileN;

enum Format { kInt8 = 0, kInt4 = 1 };

template <int FMT> struct Shape {
  static constexpr int kNSum = FMT == kInt4 ? 2 : 1;
  static constexpr int kRT = kSums / kNSum;   // rows of x per pass
};

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16(x)); }

// 16 weights of one row, columns j .. j + 15 (zero past n)
template <bool VEC>
__device__ __forceinline__ void load16(const int8_t* __restrict__ row, int j, int n,
                                       int8_t (&w)[16]) {
  if (VEC) {  // n % 16 == 0 and a 16-byte aligned row: j < n means all 16 are in
    if (j < n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j));
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int c = 0; c < 16; ++c) w[c] = b[c];
    } else {
#pragma unroll
      for (int c = 0; c < 16; ++c) w[c] = 0;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) w[c] = (j + c < n) ? row[j + c] : int8_t(0);
  }
}

// The block's GEMV over one column tile; x rows r < rows (stride ldx),
// contraction K (full width; packed int4 weights have K / 2 rows).
// res (shared, kResFloats) receives res[(a · RT + r) · kTileN + jj];
// red is shared scratch of kRedFloats.  Starts and ends with
// __syncthreads(), so the caller may reuse res right after.
template <int FMT, bool VEC>
__device__ void block_gemv(const float* __restrict__ x, int ldx, int rows, int K,
                           const int8_t* __restrict__ w, int N, int j0, float* res,
                           float* red) {
  constexpr int NS = Shape<FMT>::kNSum, RT = Shape<FMT>::kRT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid % kGroups, slice = tid / kGroups;
  const int kr = FMT == kInt4 ? K / 2 : K;  // weight rows
  const int j = j0 + grp * 16;
  float acc[NS][RT][16];
#pragma unroll
  for (int a = 0; a < NS; ++a)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[a][r][c] = 0.f;

  for (int k = slice; k < kr; k += kSlices) {
    int8_t wb[16];
    load16<VEC>(w + (int64_t)k * N, j, N, wb);
    float xv[NS][RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float* xr = x + (int64_t)r * ldx;
      xv[0][r] = r < rows ? bf16r(__ldg(xr + k)) : 0.f;
      if (NS == 2) xv[NS - 1][r] = r < rows ? bf16r(__ldg(xr + k + kr)) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (FMT == kInt4) {
        const int p = wb[c];
        const float lo = (float)(((p & 15) ^ 8) - 8);
        const float hi = (float)((((p >> 4) & 15) ^ 8) - 8);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[0][r][c] = fmaf(xv[0][r], lo, acc[0][r][c]);
          acc[NS - 1][r][c] = fmaf(xv[NS - 1][r], hi, acc[NS - 1][r][c]);
        }
      } else {
        const float wf = (float)wb[c];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[0][r][c] = fmaf(xv[0][r], wf, acc[0][r][c]);
      }
    }
  }

  // the 8 slices of a warp (lanes grp, grp + 4, ...), then the 8 warps
#pragma unroll
  for (int a = 0; a < NS; ++a)
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float v = acc[a][r][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[a][r][c] = v;
      }
  __syncthreads();  // the caller may still read res or red of a previous tile
  if (lane < kGroups) {
#pragma unroll
    for (int a = 0; a < NS; ++a)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c)
          red[(warp * kSums + a * RT + r) * kTileN + lane * 16 + c] = acc[a][r][c];
  }
  __syncthreads();
  for (int e = tid; e < kResFloats; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi * kResFloats + e];
    res[e] = s;
  }
  __syncthreads();
}

}  // namespace sa_gemv
