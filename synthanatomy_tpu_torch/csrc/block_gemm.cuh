// Shared device helpers for the training kernels (favor_attention.cu,
// local_attention.cu, res_stack.cu): operand types, rounding to the
// compute dtype, warp reductions, and a block-wide tiled product.
//
// Rounding model.  The TPU kernels run their products with operands in
// the compute dtype T (bf16 or f32) and f32 accumulation.  A bf16 value
// is exact in f32, and the product of two bf16 values is exact in f32,
// so an f32 FMA chain over operands rounded to T is that product.  The
// helpers below therefore convert every operand with `rnd<T>` (round
// to T, hold in f32) where the TPU kernel casts it, and accumulate in
// f32 in a fixed order: the result of a launch does not depend on
// scheduling, so two runs give identical bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace sa {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to T and held in f32: an operand of a product in T
template <class T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kTK = 16;  // depth of one staged k-slice

// C (M x N) = A (M x K) · B (K x N), computed by the whole block.
//
// Operands are read through accessors a(i, k) and b(k, j) that return
// f32 (they convert and round); every output element goes to epi(i, j,
// acc) exactly once.  The block walks TM x TN output tiles; for each, it
// stages TK-deep slices of A and B in shared memory (zero past the
// edges) and each thread accumulates a 4 x 4 micro-tile over k in
// increasing order.  A_KFAST / B_KFAST say whether consecutive k are
// adjacent in memory, which picks the staging order that keeps a warp's
// loads together.  Ends with __syncthreads(), so the next phase sees
// everything the epilogue wrote.
template <int TM, int TN>
struct Gemm {
  static constexpr int kThreads = TM * TN / 16;
  static constexpr int kSmemFloats = kTK * (TM + TN);
  static constexpr int kTN = TN;

  template <bool A_KFAST, bool B_KFAST, class FA, class FB, class FE>
  __device__ static void run(int M, int N, int K, FA a, FB b, FE epi, float* stage) {
    float* As = stage;             // [kTK][TM]
    float* Bs = stage + kTK * TM;  // [kTK][TN]
    const int tid = threadIdx.x;
    const int tx = tid % (TN / 4), ty = tid / (TN / 4);
    for (int i0 = 0; i0 < M; i0 += TM) {
      for (int j0 = 0; j0 < N; j0 += TN) {
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
        for (int k0 = 0; k0 < K; k0 += kTK) {
          __syncthreads();
          for (int e = tid; e < TM * kTK; e += kThreads) {
            const int ii = A_KFAST ? e / kTK : e % TM;
            const int kk = A_KFAST ? e % kTK : e / TM;
            const int gi = i0 + ii, gk = k0 + kk;
            As[kk * TM + ii] = (gi < M && gk < K) ? a(gi, gk) : 0.f;
          }
          for (int e = tid; e < TN * kTK; e += kThreads) {
            const int jj = B_KFAST ? e / kTK : e % TN;
            const int kk = B_KFAST ? e % kTK : e / TN;
            const int gj = j0 + jj, gk = k0 + kk;
            Bs[kk * TN + jj] = (gj < N && gk < K) ? b(gk, gj) : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < kTK; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(As + kk * TM + ty * 4);
            const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * TN + tx * 4);
            const float ra[4] = {av.x, av.y, av.z, av.w};
            const float rb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ra[r], rb[c], acc[r][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty * 4 + r, j = j0 + tx * 4 + c;
            if (i < M && j < N) epi(i, j, acc[r][c]);
          }
      }
    }
    __syncthreads();
  }
};

}  // namespace sa
