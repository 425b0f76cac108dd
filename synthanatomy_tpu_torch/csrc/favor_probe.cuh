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

extern "C" {

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
