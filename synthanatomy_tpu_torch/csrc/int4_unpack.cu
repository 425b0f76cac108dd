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
// One thread per packed byte; the bound is bytes (1 read, 8 written per
// byte: 0.29 MB at K2 128, N 256, ~0.1 µs at 3.35 TB/s): a launch costs
// more than the work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <int V>
__global__ void unpack_kernel(const int8_t* __restrict__ packed, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int8_t p8 = packed[i];
  float lo, hi;
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
  out[i] = lo;
  out[n + i] = hi;
}

}  // namespace

extern "C" {

// variant 0-3 = A-D; packed holds n = K2·N bytes; out (2·K2, N) f32.
// Returns a cudaError_t.
int int4_unpack(int variant, int n, const void* packed, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  float* o = static_cast<float*>(out);
  const int blocks = (n + 255) / 256;
  switch (variant) {
    case 0: unpack_kernel<0><<<blocks, 256, 0, s>>>(p, n, o); break;
    case 1: unpack_kernel<1><<<blocks, 256, 0, s>>>(p, n, o); break;
    case 2: unpack_kernel<2><<<blocks, 256, 0, s>>>(p, n, o); break;
    case 3: unpack_kernel<3><<<blocks, 256, 0, s>>>(p, n, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
