// The kernel-body probe's ablations of row 5's chunk-parallel route
// (ops/kernel_body.py), replacing the TPU probe
// tools/probe_kernel_body.py::favor_variant (:264), which patches
// _features and _tri of favor_pallas.py: favor_core.cuh's kernels built at
// one ablation, FAVOR_PROBE_BODY (FavorBody::kIdFeat, identity features,
// in favor_probe_idfeat.cu; kNoMask, no causal select, in
// favor_probe_nomask.cu: one library each, so the two build in parallel).
// The full body is production's own launches (favor_attention.cu), so it
// equals them bit for bit by construction.  Same workspace, grids and
// shared memory as production (favor_plan.h); built at m's padded widths
// 64 (bf16 and f32) and 256 (bf16), the probe's shapes.

#pragma once

#include "favor_core.cuh"

namespace fv {

// The diagnostic of the tensor cores' sum inside one product step: one
// warp runs `steps` chained mma.sync m16n8k16 (the kernels' frag::mma)
// from C on A (16, 16·steps) bf16 row-major and Bᵀ (8, 16·steps) bf16
// row-major, and writes the accumulators after each step, so the host
// can hold every step against the exactly rounded sum of its 16
// products and the accumulator it started from.
__global__ void mma_steps_kernel(const __nv_bfloat16* __restrict__ a,
                                 const __nv_bfloat16* __restrict__ bt,
                                 const float* __restrict__ c, int steps, float* __restrict__ d) {
  const int g = lane() >> 2, t = lane() & 3, K = 16 * steps;
  auto word = [](const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); };
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                  c[(g + 8) * 8 + 2 * t + 1]};
  for (int s = 0; s < steps; ++s) {
    const int k = 16 * s + 2 * t;
    const uint32_t af[4] = {word(a + g * K + k), word(a + (g + 8) * K + k),
                            word(a + g * K + k + 8), word(a + (g + 8) * K + k + 8)};
    frag::mma(acc, af, word(bt + g * K + k), word(bt + g * K + k + 8));
    float* o = d + s * 128;
    o[g * 8 + 2 * t] = acc[0];
    o[g * 8 + 2 * t + 1] = acc[1];
    o[(g + 8) * 8 + 2 * t] = acc[2];
    o[(g + 8) * 8 + 2 * t + 1] = acc[3];
  }
}

}  // namespace fv

extern "C" {

// d (steps, 16, 8) f32: the accumulators of fv::mma_steps_kernel after
// each step.  Returns a cudaError_t.
int favor_probe_mma(const void* a, const void* bt, const float* c, int steps, float* d,
                    void* stream) {
  if (steps < 1) return int(cudaErrorInvalidValue);
  fv::mma_steps_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(bt), c, steps, d);
  return int(cudaGetLastError());
}

// which 0 = the forward (o1 = out, o2 = den), 1 = the dq sweep (o1 =
// dq), 2 = the dk/dv sweep (o1 = dk, o2 = dv), each the route's state and
// scan launches and its consumer.  The shape must take the route
// (favor_route), and f32 inputs m ≤ 64.  Returns a cudaError_t.
int favor_probe(int which, int bh, int n, int d, int m, int chunk, int dtype, float dn,
                float half_dn2, float dn2, float r, const void* q, const void* k, const void* v,
                const float* P, const void* g, const float* out, const float* den, float* o1,
                float* o2, void* work, void* stream) {
  const int elem = dtype ? 2 : 4;
  if (!fp::tile_route(d, m, chunk, elem) || which < 0 || which > 2 ||
      (!dtype && fp::padded_m(m) != 64))
    return int(cudaErrorInvalidValue);
  const fv::Args A = fv::make_args(
      bh, n, d, m, chunk, elem, which != 0, dn, half_dn2, dn2, r, q, k, v, g, P, out, den,
      which == 0 ? o1 : nullptr, which == 0 ? o2 : nullptr, which == 1 ? o1 : nullptr,
      which == 2 ? o1 : nullptr, which == 2 ? o2 : nullptr, work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kind = which ? 1 : 0, parts = which == 1 ? 1 : 2;
  if (!dtype) return fv::run<float, 64, FAVOR_PROBE_BODY>(kind, parts, A, s);
  return fp::padded_m(m) == 64
             ? fv::run<__nv_bfloat16, 64, FAVOR_PROBE_BODY>(kind, parts, A, s)
             : fv::run<__nv_bfloat16, 256, FAVOR_PROBE_BODY>(kind, parts, A, s);
}

}  // extern "C"
