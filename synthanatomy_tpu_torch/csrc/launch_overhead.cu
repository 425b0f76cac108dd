// The tile program of the launch-overhead probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/probe_pallas_overhead.py: _kernel
// (:48), launched by _call (:63, pallas_call :64) over a grid of G steps
// that each add x · w into one f32 accumulator and write bf16(acc) at the
// end; x (M, K) and w (K, N) bf16 (256 × 512 and 512 × 512 in the probe),
// the same blocks at every step.  The plain twin is
// ops/probes.py::tile_steps_plain.
//
// Here the G sequential grid steps are a loop inside the block.  Each
// block owns a 64 × 64 output tile: it stages its 64 rows of x and its 64
// columns of w (transposed) in shared memory once (the TPU keeps its
// constant blocks in VMEM the same way), then runs `steps` passes of
// acc += x · w on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulators, the operand layout of local_attention_splash.cu), four
// warps of 16 rows each.  Rows padded by 8 bf16 keep a warp's fragment
// loads on 32 distinct banks.
//
// What bounds it: operations, 2·M·K·N per step (134 MFLOP at the probe's
// shape, 0.136 µs at 989 TFLOP/s); the probe measures what a launch and a
// step cost beyond that, with M·N / 64² = 32 blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // output rows and columns of a block
constexpr int kPad = 8;        // bf16 padding of a staged row
constexpr int kThreads = 128;  // four warps, 16 rows each

__host__ __device__ inline long long smem_bytes(int k) {
  return 2LL * kTile * (k + kPad) * (long long)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
tile_steps_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  int K, int N, int steps, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __nv_bfloat16 sm[];
  const int ld = K + kPad;
  __nv_bfloat16* xs = sm;               // [kTile rows][ld]
  __nv_bfloat16* wt = sm + kTile * ld;  // [kTile columns][ld], w transposed
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile, tid = threadIdx.x;
  const int per_row = K / 8;  // 16-byte chunks of a row of x
  for (int e = tid; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * 8;
    *reinterpret_cast<uint4*>(xs + r * ld + c) =
        *reinterpret_cast<const uint4*>(x + (int64_t)(i0 + r) * K + c);
  }
  for (int e = tid; e < K * kTile; e += kThreads) {
    const int k = e / kTile, j = e % kTile;
    wt[j * ld + k] = w[(int64_t)k * N + j0 + j];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* xa = xs + warp * 16 * ld;
  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;
  for (int s = 0; s < steps; ++s) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * t;
      const uint32_t a[4] = {ld32(xa + g * ld + ka), ld32(xa + (g + 8) * ld + ka),
                             ld32(xa + g * ld + ka + 8), ld32(xa + (g + 8) * ld + ka + 8)};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const __nv_bfloat16* wj = wt + (nb * 8 + g) * ld;
        const uint32_t b[2] = {ld32(wj + ka), ld32(wj + ka + 8)};
        mma_bf16(acc[nb], a, b);
      }
    }
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + warp * 16 + g + (r >> 1) * 8, col = j0 + nb * 8 + 2 * t + (r & 1);
      out[(int64_t)row * N + col] = __float2bfloat16(acc[nb][r]);
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a block needs at contraction depth k.
long long launch_overhead_smem(int k) { return smem_bytes(k); }

// out (M, N) bf16 = bf16(Σ_{steps} x · w), f32 accumulation; x (M, K), w
// (K, N) bf16; M and N multiples of 64, K of 16.  One launch; returns a
// cudaError_t.
int launch_overhead(int M, int K, int N, int steps, const void* x, const void* w, void* out,
                    void* stream) {
  static int smem_set = 0;  // the attribute, once: later launches may be captured in a graph
  const long long smem = smem_bytes(K);
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(tile_steps_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = (int)smem;
  }
  const dim3 grid(N / kTile, M / kTile);
  tile_steps_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), K, N, steps,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
