// Nibble unpack of packed int4 weights, four formulations, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of tools/probe_int4_unpack.py (kernel :142,
// pallas_call :147), which lowers one unpack sequence at a time to see
// which op family Mosaic takes:
//   A  int32 bitwise:          l = ((p & 15) ^ 8) − 8, h = (((p >> 4) & 15) ^ 8) − 8
//   B  int32 floor-div and mod
//   C  float floor arithmetic
//   D  int8 bitwise, with an arithmetic shift
// Each must equal quant.unpack_int4 exactly.  Packed (K2, N) int8 →
// (2·K2, N) f32, the low halves first, as the probe concatenates them.
// Plain twins: ops/probes.py::unpack_int4_plain.
//
// What bounds it: bytes (1 read, 8 written per byte: 0.29 MB at K2 128, N
// 256, ~0.09 µs at 3.35 TB/s), far below what a launch costs; the honest
// floor is an empty launch of the same grid.  So the kernel does as little
// per byte as it can, and keeps every memory access coalesced: a thread
// takes 16 packed bytes with one 16-byte load (a warp: 512 consecutive
// bytes) and stages them in shared memory, so that after a warp barrier
// lane l of store q reads the 4 bytes behind float4 32q + l of the warp's
// output; each thread writes its 16 low values and its 16 high values as
// four float4 stores each, every store of a warp 512 consecutive bytes.
// (Words passed round by 16 warp shuffles in place of the staging were
// slower than the one-byte-a-thread kernel before them.)  The formulation
// runs per byte as written.  Bytes past the last whole 512, or packed or
// output pointers that are not 16-byte aligned, are done one byte a thread
// (the high half's stores are 4 bytes each where N·K2 is not a multiple
// of 4).  The grid is sized to the bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 16 blocks at the probe's 32 KB

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <int V>
__device__ __forceinline__ void unpack(int8_t p8, float& lo, float& hi) {
  if (V == 0) {  // A
    const int p = p8;
    lo = (float)(((p & 15) ^ 8) - 8);
    hi = (float)((((p >> 4) & 15) ^ 8) - 8);
  } else if (V == 1) {  // B
    const int p = p8;
    const int pu = p - 256 * floordiv(p, 256);
    const int hu = floordiv(pu, 16);
    const int lu = pu - 16 * hu;
    lo = (float)(lu - 16 * floordiv(lu + 8, 16));
    hi = (float)(hu - 16 * floordiv(hu + 8, 16));
  } else if (V == 2) {  // C
    const float p = (float)p8;
    const float pu = p - 256.f * floorf(p / 256.f);
    const float hu = floorf(pu / 16.f);
    const float lu = pu - 16.f * hu;
    lo = lu - 16.f * floorf((lu + 8.f) / 16.f);
    hi = hu - 16.f * floorf((hu + 8.f) / 16.f);
  } else {  // D: every intermediate an int8, >> arithmetic on int8
    const int8_t l8 = (int8_t)((int8_t)((int8_t)(p8 & (int8_t)15) ^ (int8_t)8) - (int8_t)8);
    const int8_t sh = (int8_t)(p8 >> 4);
    const int8_t h8 = (int8_t)((int8_t)((int8_t)(sh & (int8_t)15) ^ (int8_t)8) - (int8_t)8);
    lo = (float)l8;
    hi = (float)h8;
  }
}

// Threads 0 … nvec − 1 (whole warps) take 16 bytes each; the rest one
// byte each, from byte 16·nvec on.
template <int V>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const int8_t* __restrict__ packed, int n, int nvec, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < nvec) {
    __shared__ int4 stage[kThreads];  // each warp's 512 bytes
    stage[threadIdx.x] = reinterpret_cast<const int4*>(packed)[i];
    __syncwarp();
    const int lane = threadIdx.x % 32;
    const int* words = reinterpret_cast<const int*>(stage + (threadIdx.x - lane));
    const int64_t warp0 = 16 * (int64_t)(i - lane);  // the warp's first byte
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int word = words[32 * q + lane];  // the bytes of float4 32q + lane
      float lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) unpack<V>((int8_t)(word >> (8 * e)), lo[e], hi[e]);
      const int64_t b = warp0 + 4 * (32 * q + lane);
      *reinterpret_cast<float4*>(out + b) = make_float4(lo[0], lo[1], lo[2], lo[3]);
      if (n % 4 == 0) {
        *reinterpret_cast<float4*>(out + n + b) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n + b + e] = hi[e];
      }
    }
    return;
  }
  const int b = 16 * nvec + (i - nvec);
  if (b >= n) return;
  float lo, hi;
  unpack<V>(packed[b], lo, hi);
  out[b] = lo;
  out[n + b] = hi;
}

// 16-byte pieces: those of every whole 512 bytes (a warp's) where both
// pointers are 16-byte aligned
int pieces(int n, const void* packed, const void* out) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(out);
  return (both & 15) == 0 ? 32 * (n / 512) : 0;
}

int grid(int n, int nvec) { return (nvec + (n - 16 * nvec) + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// The launch's geometry for n bytes at these pointers, into geometry[0..2]:
// blocks, threads a block, and the 16-byte pieces (threads of the vector
// path; the other n − 16·pieces bytes take one thread each).
void int4_unpack_grid(int n, const void* packed, const void* out, int* geometry) {
  geometry[2] = pieces(n, packed, out);
  geometry[0] = grid(n, geometry[2]);
  geometry[1] = kThreads;
}

// variant 0-3 = A-D; packed holds n = K2·N bytes; out (2·K2, N) f32.
// Returns a cudaError_t.
int int4_unpack(int variant, int n, const void* packed, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  float* o = static_cast<float*>(out);
  const int nvec = pieces(n, packed, out), blocks = grid(n, nvec);
  switch (variant) {
    case 0: unpack_kernel<0><<<blocks, kThreads, 0, s>>>(p, n, nvec, o); break;
    case 1: unpack_kernel<1><<<blocks, kThreads, 0, s>>>(p, n, nvec, o); break;
    case 2: unpack_kernel<2><<<blocks, kThreads, 0, s>>>(p, n, nvec, o); break;
    case 3: unpack_kernel<3><<<blocks, kThreads, 0, s>>>(p, n, nvec, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
