// Weight-only quantized GEMV for Hopper (sm_90a): x (R, K) f32 times
// int8 weights (K, N) with a per-channel f32 scale, and the packed-int4
// product the int4 probes run.
//
// Replaces the TPU kernel of synthanatomy_tpu/ops/quant.py: _kernel
// (:103), launched by _int8_matmul_pallas (:112, pallas_call :119) under
// int8_matmul (:139): out = (bf16(x) · bf16(w_q)) accumulated in f32,
// THEN × scale, as the Pallas body applies it.  The plain PyTorch twin is
// ops/quant.py::int8_matmul_plain.  The packed product (int4_matmul) is
// the body of tools/probe_int4_unpack.py's E (kernel_dot :79) and F
// (kernel_grid :107): weights (L, K/2, N) nibble-packed along K, out =
// (x_lo · lo) × s[0] + (x_hi · hi) × s[1]; with L > 1 one launch walks the
// L layer blocks in order and the output is the last layer's product, as
// the TPU grid's constant output block leaves it.  Twin:
// ops/quant.py::int4_matmul_plain.
//
// Any R, K and N: the JAX wrapper pads R to 8 and needs a 128-multiple
// block of N; here ragged N is masked (16-byte loads where N % 16 == 0
// and the weights are aligned, byte loads otherwise) and R runs in passes
// of 8 (int8) or 4 (int4) rows.  The products are this kernel's own FMAs
// (weight_gemv.cuh); no cuBLAS.
//
// What bounds it: the weights are read once, K·N bytes (+ 4·(R·K + R·N +
// N)); at the paper decode shapes (R 16, K×N 512×2048) about 1.2 MB, 0.35
// µs at 3.35 TB/s, below a launch's own cost: the kernel is launch-bound,
// and one 64-column tile per block keeps N/64 blocks on the card.

#include "weight_gemv.cuh"

namespace {

using namespace sa_gemv;

template <int FMT, bool VEC>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ x, int R, int K, const int8_t* __restrict__ w,
              const float* __restrict__ scale, int N, int layers, float* __restrict__ out) {
  __shared__ float red[kRedFloats];
  __shared__ float res[kResFloats];
  constexpr int RT = Shape<FMT>::kRT;
  const int j0 = blockIdx.x * kTileN, r0 = blockIdx.y * RT;
  const int rows = min(RT, R - r0);
  const int64_t layer_w = (int64_t)(FMT == kInt4 ? K / 2 : K) * N;
  const int layer_s = (FMT == kInt4 ? 2 : 1) * N;
  for (int l = 0; l < layers; ++l) {
    const float* s = scale + (int64_t)l * layer_s;
    block_gemv<FMT, VEC>(x + (int64_t)r0 * K, K, rows, K, w + l * layer_w, N, j0, res, red);
    for (int e = threadIdx.x; e < rows * kTileN; e += kThreads) {
      const int r = e / kTileN, jj = e % kTileN, j = j0 + jj;
      if (j >= N) continue;
      float y = res[r * kTileN + jj] * s[j];
      if (FMT == kInt4) y += res[(RT + r) * kTileN + jj] * s[N + j];
      out[(int64_t)(r0 + r) * N + j] = y;
    }
  }
}

template <int FMT>
int launch(int R, int K, int N, int layers, const void* x, const void* w, const void* scale,
           void* out, int vec, cudaStream_t s) {
  const dim3 grid((N + kTileN - 1) / kTileN, (R + Shape<FMT>::kRT - 1) / Shape<FMT>::kRT);
  auto args = [&](auto kern) {
    kern<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), R, K,
                                   static_cast<const int8_t*>(w),
                                   static_cast<const float*>(scale), N, layers,
                                   static_cast<float*>(out));
  };
  if (vec)
    args(matmul_kernel<FMT, true>);
  else
    args(matmul_kernel<FMT, false>);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (R, N) f32 = (bf16(x) · w_q) × scale; x (R, K) f32, w_q (K, N)
// int8, scale (N,) f32.  vec: N % 16 == 0 and w_q 16-byte aligned.
// Returns a cudaError_t.
int int8_matmul(int R, int K, int N, const void* x, const void* w, const void* scale,
                void* out, int vec, void* stream) {
  return launch<kInt8>(R, K, N, 1, x, w, scale, out, vec, static_cast<cudaStream_t>(stream));
}

// out (R, N) f32 = (bf16(x_lo) · lo) × s[0] + (bf16(x_hi) · hi) × s[1] of
// the last of `layers` layer blocks; w (layers, K/2, N) packed int8,
// scale (layers, 2, N) f32.
int int4_matmul(int R, int K, int N, int layers, const void* x, const void* w,
                const void* scale, void* out, int vec, void* stream) {
  return launch<kInt4>(R, K, N, layers, x, w, scale, out, vec,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
