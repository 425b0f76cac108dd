// Nearest-codeword search (the VQ argmin) and its EMA statistics, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of synthanatomy_tpu/ops/vq.py:
// _vq_argmin_kernel (:103, launched by nearest_codeword_pallas :122) and
// _vq_argmin_stats_kernel (:176, launched by nearest_codeword_stats_pallas
// :227).  The plain PyTorch twins are ops/vq.py (nearest_codeword_plain,
// nearest_codeword_stats_plain).
//
// x (N, D) and the codebook w (K, D) are f32.  For each row n the kernel
// returns argmin_k ‖w_k‖² − 2·x_n·w_k (the row-constant ‖x_n‖² dropped,
// as the TPU kernel drops it), in full f32: plain FMAs, no TF32 or bf16,
// or the indices drift.  Ties go to the lower index, as jnp.argmin and
// torch.argmin break them.  Ragged N and K are masked in the kernel; no
// padded copy and no +inf columns.
//
// Kernels:
//   vq_argmin_kernel  one block per 16 rows, 16 lanes per row; the
//                     codebook walks through shared memory in tiles of
//                     128 codewords (with their ‖w‖²); each lane keeps a
//                     running (min, index) over the codewords it owns in
//                     increasing order, then the 16 lanes reduce with
//                     ties to the lower index;
//   vq_stats_kernel   (the statistics variant's second pass) one warp
//                     per codeword: it walks the indices in row order,
//                     32 at a time, and adds the rows that chose it:
//                     counts (K,) and Σx (K, D) in f32, in a fixed
//                     order, with no float atomics, so two runs give
//                     identical bits.  No (N, K) one-hot is formed.
//
// What bounds it on the card: neither bytes nor operations.  At the
// paper shape (N = 4200 rows at B3, K 2048, D 32) the search is 2·N·K·D
// ≈ 0.55 GFLOP, ~8 µs at the 67 TFLOP/s f32 peak, and moves ~0.8 MB; a
// launch and the tail of ~260 blocks take about as long.  The design
// keeps it to one launch (two for the statistics) and fills the card
// with small row tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;                // rows of x per block
constexpr int kLanes = 16;               // lanes per row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kCodes = 128;              // codewords per staged tile
constexpr int kMaxD = 256;               // the wrapper refuses wider rows
constexpr int kStatWarps = 8;            // codewords per stats block

// shared floats: x rows and codeword rows padded to D + 1 (no bank
// conflicts between lanes), plus ‖w‖² of the tile
__host__ __device__ inline int argmin_smem_floats(int d) {
  return (kRows + kCodes) * (d + 1) + kCodes;
}

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ x, const float* __restrict__ w, int n, int k, int d,
                 int* __restrict__ idx) {
  extern __shared__ float sm[];
  const int ld = d + 1;
  float* xs = sm;                  // [kRows][ld]
  float* ws = xs + kRows * ld;     // [kCodes][ld]
  float* wsq = ws + kCodes * ld;   // [kCodes]
  const int tid = threadIdx.x;
  const int row = tid / kLanes, lane = tid % kLanes;
  const int r0 = blockIdx.x * kRows;

  for (int e = tid; e < kRows * d; e += kThreads) {
    const int rr = e / d, dd = e % d;
    xs[rr * ld + dd] = (r0 + rr < n) ? x[(int64_t)(r0 + rr) * d + dd] : 0.f;
  }
  float best = 0.f;
  int best_i = -1;
  for (int c0 = 0; c0 < k; c0 += kCodes) {
    const int nc = min(kCodes, k - c0);
    __syncthreads();
    for (int e = tid; e < nc * d; e += kThreads) {
      const int cc = e / d, dd = e % d;
      ws[cc * ld + dd] = w[(int64_t)(c0 + cc) * d + dd];
    }
    __syncthreads();
    for (int cc = tid; cc < nc; cc += kThreads) {
      float s = 0.f;
      for (int dd = 0; dd < d; ++dd) s = fmaf(ws[cc * ld + dd], ws[cc * ld + dd], s);
      wsq[cc] = s;
    }
    __syncthreads();
    const float* xr = xs + row * ld;
    for (int cc = lane; cc < nc; cc += kLanes) {
      const float* wr = ws + cc * ld;
      float dot = 0.f;
      for (int dd = 0; dd < d; ++dd) dot = fmaf(xr[dd], wr[dd], dot);
      const float dist = wsq[cc] - 2.f * dot;
      // codewords arrive in increasing order: strict < keeps the first
      if (best_i < 0 || dist < best) {
        best = dist;
        best_i = c0 + cc;
      }
    }
  }
  // the 16 lanes of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (oi >= 0 && (best_i < 0 || better(od, oi, best, best_i))) {
      best = od;
      best_i = oi;
    }
  }
  if (lane == 0 && r0 + row < n) idx[r0 + row] = best_i;
}

__global__ void __launch_bounds__(kStatWarps * 32)
vq_stats_kernel(const float* __restrict__ x, const int* __restrict__ idx, int n, int k, int d,
                float* __restrict__ counts, float* __restrict__ dw) {
  const int lane = threadIdx.x % 32;
  const int code = blockIdx.x * kStatWarps + threadIdx.x / 32;
  if (code >= k) return;
  float acc[kMaxD / 32];
#pragma unroll
  for (int j = 0; j < kMaxD / 32; ++j) acc[j] = 0.f;
  int count = 0;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    unsigned hit = __ballot_sync(0xffffffffu, r < n && idx[r] == code);
    count += __popc(hit);
    while (hit) {  // the rows that chose this codeword, in row order
      const int b = __ffs(hit) - 1;
      hit &= hit - 1;
      const float* xr = x + (int64_t)(r0 + b) * d;
#pragma unroll
      for (int j = 0; j < kMaxD / 32; ++j) {
        const int dd = lane + 32 * j;
        if (dd < d) acc[j] += xr[dd];
      }
    }
  }
  if (lane == 0) counts[code] = (float)count;
#pragma unroll
  for (int j = 0; j < kMaxD / 32; ++j) {
    const int dd = lane + 32 * j;
    if (dd < d) dw[(int64_t)code * d + dd] = acc[j];
  }
}

int launch_argmin(int n, int k, int d, const float* x, const float* w, int* idx,
                  cudaStream_t s) {
  const size_t smem = sizeof(float) * argmin_smem_floats(d);
  cudaError_t e = cudaFuncSetAttribute(vq_argmin_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  vq_argmin_kernel<<<(n + kRows - 1) / kRows, kThreads, smem, s>>>(x, w, n, k, d, idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of the argmin kernel for rows of width
// d; the wrapper refuses d > vq_max_d().
long long vq_smem_bytes(int d) { return (long long)sizeof(float) * argmin_smem_floats(d); }
int vq_max_d() { return kMaxD; }

// One launch.  Returns a cudaError_t.
int vq_argmin(int n, int k, int d, const void* x, const void* w, void* idx, void* stream) {
  return launch_argmin(n, k, d, static_cast<const float*>(x), static_cast<const float*>(w),
                       static_cast<int*>(idx), static_cast<cudaStream_t>(stream));
}

// Two launches: the argmin, then the per-codeword statistics.
int vq_argmin_stats(int n, int k, int d, const void* x, const void* w, void* idx,
                    void* counts, void* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int err = launch_argmin(n, k, d, xf, static_cast<const float*>(w), static_cast<int*>(idx), s);
  if (err) return err;
  vq_stats_kernel<<<(k + kStatWarps - 1) / kStatWarps, kStatWarps * 32, 0, s>>>(
      xf, static_cast<const int*>(idx), n, k, d, static_cast<float*>(counts),
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // extern "C"
