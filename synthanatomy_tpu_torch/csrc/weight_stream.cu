// The L-layer weight-stream chain of the int4 probe, for Hopper (sm_90a).
//
// Replaces the TPU kernels of tools/probe_int4.py: make().kernel (:49,
// pallas_call :69; int8 and jnp.int4 weights) and make_packed().kernel
// (:108, pallas_call :131; nibble-packed int4).  Over a grid of L layers
// the TPU kernel adds into one VMEM accumulator
//
//     acc += fold(bf16(x) · W_i · s_i) · 1e-3,   fold: (B, N) → (B, K),
//     summing y.reshape(B, N/K, K) over its middle axis,
//
// with x (B, K) bf16, W (L, K, N) int8 or packed (L, K/2, N), s (L, 1, N)
// f32 (the packed form scales lo + hi by the one s_i).  The plain twin is
// ops/probes.py::weight_stream_plain.  On this card jnp.int4 has
// no tensor type of its own: its nibble-packed layout is the packed form.
//
// Blocks run in parallel here, so the sequential layer grid becomes a
// split of L × (K/64 column tiles) over the blocks: block (tile, i)
// computes layer i's products for the columns tile + g·K of every fold
// group g (weight_gemv.cuh), folds them in g order and writes one
// partial (L, B, K); a second kernel adds the partials over i in order,
// × 1e-3.  No atomics: two runs give identical bits.
//
// What bounds it: the weights, read once: L·K·N bytes (100.7 MB int8,
// 50.3 MB packed at B 16, K 512, N 2048, L 96), ~30 µs or ~15 µs at 3.35
// TB/s; the partials add 2·L·B·K·4 bytes (6.3 MB).  The probe asks whether
// packed int4 halves the weight stream's time on this card.

#include "weight_gemv.cuh"

namespace {

using namespace sa_gemv;

template <int FMT, bool VEC>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ x, int B, int K, const int8_t* __restrict__ w,
              const float* __restrict__ s, int N, float* __restrict__ partial) {
  __shared__ float red[kRedFloats];
  __shared__ float res[kResFloats];
  constexpr int RT = Shape<FMT>::kRT;
  const int c0 = blockIdx.x * kTileN, i = blockIdx.y;
  const int64_t layer_w = (int64_t)(FMT == kInt4 ? K / 2 : K) * N;
  const int8_t* wi = w + i * layer_w;
  const float* si = s + (int64_t)i * N;
  for (int r0 = 0; r0 < B; r0 += RT) {
    const int rows = min(RT, B - r0);
    for (int g = 0; g < N / K; ++g) {
      block_gemv<FMT, VEC>(x + (int64_t)r0 * K, K, rows, K, wi, N, g * K + c0, res, red);
      // each (r, column) belongs to one thread of one block: fold in g order
      for (int e = threadIdx.x; e < rows * kTileN; e += kThreads) {
        const int r = e / kTileN, jj = e % kTileN, col = c0 + jj;
        if (col >= K) continue;
        float y = res[r * kTileN + jj];
        if (FMT == kInt4) y += res[(RT + r) * kTileN + jj];
        y *= si[g * K + col];
        float* p = partial + ((int64_t)i * B + r0 + r) * K + col;
        *p = g == 0 ? y : *p + y;
      }
    }
  }
}

__global__ void reduce_kernel(const float* __restrict__ partial, int L, int n,
                              float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int i = 0; i < L; ++i) acc += partial[(int64_t)i * n + e] * 1e-3f;
  out[e] = acc;
}

template <int FMT>
void launch_stream(int L, int B, int K, int N, const float* x, const int8_t* w, const float* s,
                   float* partial, int vec, cudaStream_t st) {
  const dim3 grid((K + kTileN - 1) / kTileN, L);
  if (vec)
    stream_kernel<FMT, true><<<grid, kThreads, 0, st>>>(x, B, K, w, s, N, partial);
  else
    stream_kernel<FMT, false><<<grid, kThreads, 0, st>>>(x, B, K, w, s, N, partial);
}

}  // namespace

extern "C" {

// fmt 0: W (L, K, N) int8; fmt 1: W (L, K/2, N) packed int4.  x (B, K)
// f32 (bf16 values), s (L, N) f32, partial (L, B, K) f32 scratch, out
// (B, K) f32.  N must be a multiple of K.  vec: N and K multiples of 16
// and W 16-byte aligned.  Two launches; returns a cudaError_t.
int weight_stream(int fmt, int L, int B, int K, int N, const void* x, const void* w,
                  const void* s, void* partial, void* out, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sf = static_cast<const float*>(s);
  float* pf = static_cast<float*>(partial);
  if (fmt == 1)
    launch_stream<kInt4>(L, B, K, N, xf, wq, sf, pf, vec, st);
  else
    launch_stream<kInt8>(L, B, K, N, xf, wq, sf, pf, vec, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = B * K;
  reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(pf, L, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
