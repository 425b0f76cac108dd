// Banded causal local-window attention for Hopper (sm_90a): forward and
// a recomputing, deterministic backward.
//
// Replaces the TPU kernels of synthanatomy_tpu/ops/local_attention_pallas.py:
// _fwd_kernel (:128) and _bwd_kernel (:164), launched by
// local_attention_flash (:400).  The plain PyTorch twin is
// ops/local_attention_flash.py (local_fwd_plain, local_bwd_plain).
//
// q, k, v (and the cotangent g) are (B·H, L, d) in T (bf16 or f32),
// after rotary.  Query i attends to keys j with i − w < j ≤ i, j ≥ 0.
// Rounding as the TPU kernels round:
//   forward   scores = rnd(q·d^-1/2)·kᵀ, e = exp(s − rowmax), out =
//             (rnd(e)·v) / Σe, written in T;
//   backward  scores = (q·kᵀ)·d^-1/2, P = e / Σe (f32), dP = g·vᵀ,
//             dS = P·(dP − Σ dP·P), dq = rnd(dS)·k·d^-1/2, dk =
//             rnd(dS)ᵀ·q·d^-1/2, dv = rnd(P)ᵀ·g.
// The TPU kernel writes each query block's dk/dv share in T and folds
// the shares in f32; here a key block sums its shares in f32 and rounds
// once, and nothing is added with atomics, so two runs give identical
// gradients.
//
// Kernels:
//   local_fwd_kernel    one block per (32 queries, head): the 32 x (32 +
//                       w − 1) score band in shared memory;
//   local_bwd_dq_kernel the same band, recomputed, for dq; it also writes
//                       each row's max, Σe and Σ dP·P (f32, B·H x L);
//   local_bwd_dkv_kernel one block per (32 keys, head): walks the 32 + w −
//                       1 queries that see them in tiles of 64, rebuilding
//                       P and dS from the row statistics.
//   probe_*_kernel      the same bodies with compile-time ablations and
//                       several heads per block: they replace the Pallas
//                       bodies of tools/probe_kernel_body.py
//                       (local_fwd_variant :93, local_bwd_variant :168);
//                       wrappers in ops/kernel_body.py.
//
// What bounds it on the card: the band is w·d multiply-adds per query
// and product (~0.12 GFLOP per head per product at the paper shape, L
// 1400, w 420, d 64), so operations.  Products are f32 FMAs over staged
// tiles (block_gemm.cuh), off the tensor cores; ~2100 blocks fill the
// card.  wgmma and TMA are later work.

#include <stdint.h>

#include "block_gemm.cuh"

using sa::from_f;
using sa::rnd;
using sa::to_f;
using sa::warp_max;
using sa::warp_sum;

namespace {

using G = sa::Gemm<32, 64>;
constexpr int kThreads = G::kThreads;  // 128
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 32;  // query rows per block (forward, dq)
constexpr int kKT = 32;  // key rows per block (dk/dv)
constexpr int kQS = 64;  // query tile of the dk/dv walk

struct Band {
  int n, d, w;
  float scale;  // d^-1/2
};

__device__ __forceinline__ bool allowed(const Band& B, int i, int j) {
  return j <= i && j > i - B.w && j >= 0;
}

// shared floats of the forward and dq kernels: `arrays` score bands of
// 32 x (32 + w − 1), the row sums, then the staging tiles (16-byte aligned)
__host__ __device__ inline int band_ld(int w) { return kQT + w - 1; }
__host__ __device__ inline int band_stage(int w, int arrays) {
  return (arrays * kQT * band_ld(w) + kQT + 3) / 4 * 4;
}

// the dk/dv kernel: P and dS tiles (32 x 64), dK and dV sums (32 x d)
__host__ __device__ inline int dkv_stage(int d) {
  return (2 * kKT * kQS + 2 * kKT * d + 3) / 4 * 4;
}

// Bodies of the kernel-body probe (ops/kernel_body.py), compile-time
// ablations of the kernels below; the production kernels instantiate
// FwdBody::kFoldScale and BwdBody::kFull with outputs in T.
//   forward  kFoldScale  d^-1/2 folded into q, Σe divided after P·V
//            kFull       scores scaled, P = e/Σe normalised before P·V
//            kDefer      scores scaled, Σe divided after P·V
//            kNoMax      as kFull, without the row max before exp
//            kMatmuls    P = the scaled scores, 0 outside the band
//   backward kFull       the softmax chain
//            kMatmuls    P = the scaled scores and dS = dP, 0 outside
//                        the band; no row statistics
namespace FwdBody {
enum { kFoldScale = 0, kFull, kDefer, kNoMax, kMatmuls };
}
namespace BwdBody {
enum { kFull = 0, kMatmuls };
}

// One block's forward: 32 queries from q0 of the (batch·head) row bh.
template <class T, int Body>
__device__ __forceinline__ void local_fwd_body(const Band& B, long long bh, int q0,
                                               const T* __restrict__ q,
                                               const T* __restrict__ k,
                                               const T* __restrict__ v, T* __restrict__ out,
                                               float* smem) {
  constexpr bool kFold = Body == FwdBody::kFoldScale;
  constexpr bool kSoftmax = Body != FwdBody::kMatmuls;
  constexpr bool kNormFirst = Body == FwdBody::kFull || Body == FwdBody::kNoMax;
  const int n = B.n, d = B.d, ld = band_ld(B.w);
  float* SC = smem;              // kQT x ld
  float* lsum = SC + kQT * ld;   // kQT
  float* stage = smem + band_stage(B.w, 1);
  const int rows = min(kQT, n - q0);
  const int ks = max(0, q0 - B.w + 1), span = q0 + rows - ks;
  q += bh * n * d;
  k += bh * n * d;
  v += bh * n * d;
  out += bh * n * d;
  const float scale = B.scale;
  G::run<true, true>(
      rows, span, d,
      [&](int i, int e) {
        if constexpr (kFold) return rnd<T>(to_f(q[(q0 + i) * d + e]) * scale);
        else return to_f(q[(q0 + i) * d + e]);
      },
      [&](int e, int j) { return to_f(k[(ks + j) * d + e]); },
      [&](int i, int j, float acc) {
        const bool in = allowed(B, q0 + i, ks + j);
        if constexpr (kFold) SC[i * ld + j] = in ? acc : -INFINITY;
        else SC[i * ld + j] = in ? acc * scale : (kSoftmax ? -INFINITY : 0.f);
      },
      stage);
  if constexpr (kSoftmax) {
    for (int i = threadIdx.x >> 5; i < rows; i += kWarps) {
      const int lane = threadIdx.x & 31;
      float mx = 0.f, s = 0.f;
      if constexpr (Body != FwdBody::kNoMax) {
        mx = -INFINITY;
        for (int j = lane; j < span; j += 32) mx = fmaxf(mx, SC[i * ld + j]);
        mx = warp_max(mx);
      }
      for (int j = lane; j < span; j += 32) {
        const float e = Body == FwdBody::kNoMax ? expf(SC[i * ld + j]) : expf(SC[i * ld + j] - mx);
        SC[i * ld + j] = e;
        s += e;
      }
      s = warp_sum(s);
      if constexpr (kNormFirst) {
        for (int j = lane; j < span; j += 32) SC[i * ld + j] = SC[i * ld + j] / s;
      } else {
        if (lane == 0) lsum[i] = s;
      }
    }
    __syncthreads();
  }
  G::run<true, false>(
      rows, d, span, [&](int i, int j) { return rnd<T>(SC[i * ld + j]); },
      [&](int j, int e) { return to_f(v[(ks + j) * d + e]); },
      [&](int i, int e, float acc) {
        if constexpr (kSoftmax && !kNormFirst) out[(q0 + i) * d + e] = from_f<T>(acc / lsum[i]);
        else out[(q0 + i) * d + e] = from_f<T>(acc);
      },
      stage);
}

// One block's dq (and, with the softmax, the row statistics): 32 queries
// from q0 of row bh; gradients written in O.
template <class T, class O, int Body>
__device__ __forceinline__ void local_bwd_dq_body(const Band& B, long long bh, int q0,
                                                  const T* __restrict__ q,
                                                  const T* __restrict__ k,
                                                  const T* __restrict__ v,
                                                  const T* __restrict__ g, O* __restrict__ dq,
                                                  float* __restrict__ rmax,
                                                  float* __restrict__ rsum,
                                                  float* __restrict__ rdot, float* smem) {
  constexpr bool kSoftmax = Body == BwdBody::kFull;
  const int n = B.n, d = B.d, ld = band_ld(B.w);
  float* P = smem;               // kQT x ld: scores, then probabilities
  float* DS = P + kQT * ld;      // kQT x ld: dP, then dS
  float* stage = smem + band_stage(B.w, 2);
  const int rows = min(kQT, n - q0);
  const int ks = max(0, q0 - B.w + 1), span = q0 + rows - ks;
  q += bh * n * d;
  k += bh * n * d;
  v += bh * n * d;
  g += bh * n * d;
  dq += bh * n * d;
  rmax += bh * n;
  rsum += bh * n;
  rdot += bh * n;
  const float scale = B.scale;
  G::run<true, true>(
      rows, span, d, [&](int i, int e) { return to_f(q[(q0 + i) * d + e]); },
      [&](int e, int j) { return to_f(k[(ks + j) * d + e]); },
      [&](int i, int j, float acc) {
        P[i * ld + j] =
            allowed(B, q0 + i, ks + j) ? acc * scale : (kSoftmax ? -INFINITY : 0.f);
      },
      stage);
  if constexpr (kSoftmax) {
    for (int i = threadIdx.x >> 5; i < rows; i += kWarps) {
      const int lane = threadIdx.x & 31;
      float mx = -INFINITY, s = 0.f;
      for (int j = lane; j < span; j += 32) mx = fmaxf(mx, P[i * ld + j]);
      mx = warp_max(mx);
      for (int j = lane; j < span; j += 32) {
        const float e = expf(P[i * ld + j] - mx);
        P[i * ld + j] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int j = lane; j < span; j += 32) P[i * ld + j] = P[i * ld + j] / s;
      if (lane == 0) {
        rmax[q0 + i] = mx;
        rsum[q0 + i] = s;
      }
    }
  }
  G::run<true, true>(
      rows, span, d, [&](int i, int e) { return to_f(g[(q0 + i) * d + e]); },
      [&](int e, int j) { return to_f(v[(ks + j) * d + e]); },
      [&](int i, int j, float acc) {
        if constexpr (kSoftmax) DS[i * ld + j] = acc;
        else DS[i * ld + j] = allowed(B, q0 + i, ks + j) ? acc : 0.f;
      },
      stage);
  if constexpr (kSoftmax) {
    for (int i = threadIdx.x >> 5; i < rows; i += kWarps) {
      const int lane = threadIdx.x & 31;
      float t = 0.f;
      for (int j = lane; j < span; j += 32) t += DS[i * ld + j] * P[i * ld + j];
      t = warp_sum(t);
      for (int j = lane; j < span; j += 32) DS[i * ld + j] = P[i * ld + j] * (DS[i * ld + j] - t);
      if (lane == 0) rdot[q0 + i] = t;
    }
    __syncthreads();
  }
  G::run<true, false>(
      rows, d, span, [&](int i, int j) { return rnd<T>(DS[i * ld + j]); },
      [&](int j, int e) { return to_f(k[(ks + j) * d + e]); },
      [&](int i, int e, float acc) { dq[(q0 + i) * d + e] = from_f<O>(acc * scale); }, stage);
}

// One block's dk/dv: 32 keys from k0 of row bh, in O.
template <class T, class O, int Body>
__device__ __forceinline__ void local_bwd_dkv_body(const Band& B, long long bh, int k0,
                                                   const T* __restrict__ q,
                                                   const T* __restrict__ k,
                                                   const T* __restrict__ v,
                                                   const T* __restrict__ g,
                                                   const float* __restrict__ rmax,
                                                   const float* __restrict__ rsum,
                                                   const float* __restrict__ rdot,
                                                   O* __restrict__ dk, O* __restrict__ dv,
                                                   float* smem) {
  constexpr bool kSoftmax = Body == BwdBody::kFull;
  const int n = B.n, d = B.d;
  float* PT = smem;               // kKT x kQS: P of (key, query)
  float* DST = PT + kKT * kQS;    // kKT x kQS: dS of (key, query)
  float* DK = DST + kKT * kQS;    // kKT x d
  float* DV = DK + kKT * d;       // kKT x d
  float* stage = smem + dkv_stage(d);
  const int kr = min(kKT, n - k0);
  const int qe = min(n, k0 + kr - 1 + B.w);  // queries [k0, qe) see some key of the block
  q += bh * n * d;
  k += bh * n * d;
  v += bh * n * d;
  g += bh * n * d;
  dk += bh * n * d;
  dv += bh * n * d;
  rmax += bh * n;
  rsum += bh * n;
  rdot += bh * n;
  for (int i = threadIdx.x; i < 2 * kKT * d; i += kThreads) DK[i] = 0.f;
  const float scale = B.scale;
  for (int i0 = k0; i0 < qe; i0 += kQS) {
    const int nq = min(kQS, qe - i0);
    // the same products, in the same order, as the dq kernel's: P and dS
    // come out bit for bit as there
    G::run<true, true>(
        kr, nq, d, [&](int j, int e) { return to_f(k[(k0 + j) * d + e]); },
        [&](int e, int i) { return to_f(q[(i0 + i) * d + e]); },
        [&](int j, int i, float acc) {
          const int qi = i0 + i;
          if constexpr (kSoftmax)
            PT[j * kQS + i] =
                allowed(B, qi, k0 + j) ? expf(acc * scale - rmax[qi]) / rsum[qi] : 0.f;
          else PT[j * kQS + i] = allowed(B, qi, k0 + j) ? acc * scale : 0.f;
        },
        stage);
    G::run<true, true>(
        kr, nq, d, [&](int j, int e) { return to_f(v[(k0 + j) * d + e]); },
        [&](int e, int i) { return to_f(g[(i0 + i) * d + e]); },
        [&](int j, int i, float acc) {
          if constexpr (kSoftmax) DST[j * kQS + i] = PT[j * kQS + i] * (acc - rdot[i0 + i]);
          else DST[j * kQS + i] = allowed(B, i0 + i, k0 + j) ? acc : 0.f;
        },
        stage);
    G::run<true, false>(
        kr, d, nq, [&](int j, int i) { return rnd<T>(DST[j * kQS + i]); },
        [&](int i, int e) { return to_f(q[(i0 + i) * d + e]); },
        [&](int j, int e, float acc) { DK[j * d + e] += acc; }, stage);
    G::run<true, false>(
        kr, d, nq, [&](int j, int i) { return rnd<T>(PT[j * kQS + i]); },
        [&](int i, int e) { return to_f(g[(i0 + i) * d + e]); },
        [&](int j, int e, float acc) { DV[j * d + e] += acc; }, stage);
  }
  for (int x = threadIdx.x; x < kr * d; x += kThreads) {
    dk[k0 * d + x] = from_f<O>(DK[x] * scale);
    dv[k0 * d + x] = from_f<O>(DV[x]);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
local_fwd_kernel(Band B, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out) {
  extern __shared__ float smem[];
  local_fwd_body<T, FwdBody::kFoldScale>(B, blockIdx.y, blockIdx.x * kQT, q, k, v, out, smem);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
local_bwd_dq_kernel(Band B, const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
                    float* __restrict__ rmax, float* __restrict__ rsum,
                    float* __restrict__ rdot) {
  extern __shared__ float smem[];
  local_bwd_dq_body<T, T, BwdBody::kFull>(B, blockIdx.y, blockIdx.x * kQT, q, k, v, g, dq,
                                          rmax, rsum, rdot, smem);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
local_bwd_dkv_kernel(Band B, const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ rmax, const float* __restrict__ rsum,
                     const float* __restrict__ rdot, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float smem[];
  local_bwd_dkv_body<T, T, BwdBody::kFull>(B, blockIdx.y, blockIdx.x * kKT, q, k, v, g, rmax,
                                           rsum, rdot, dk, dv, smem);
}

// The probe's kernels: the same bodies, each block walking `hpb`
// (batch·head) rows in turn with the same shared memory (the counterpart
// of the TPU kernels' batch·head tile bt); grid.y = ceil(bh / hpb).
template <class T, int Body>
__global__ void __launch_bounds__(kThreads)
probe_fwd_kernel(Band B, int bh, int hpb, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * hpb, r1 = min(bh, r0 + hpb);
  for (int r = r0; r < r1; ++r) {
    __syncthreads();
    local_fwd_body<T, Body>(B, r, blockIdx.x * kQT, q, k, v, out, smem);
  }
}

template <class T, class O, int Body>
__global__ void __launch_bounds__(kThreads)
probe_bwd_dq_kernel(Band B, int bh, int hpb, const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g, O* __restrict__ dq,
                    float* __restrict__ rmax, float* __restrict__ rsum,
                    float* __restrict__ rdot) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * hpb, r1 = min(bh, r0 + hpb);
  for (int r = r0; r < r1; ++r) {
    __syncthreads();
    local_bwd_dq_body<T, O, Body>(B, r, blockIdx.x * kQT, q, k, v, g, dq, rmax, rsum, rdot,
                                  smem);
  }
}

template <class T, class O, int Body>
__global__ void __launch_bounds__(kThreads)
probe_bwd_dkv_kernel(Band B, int bh, int hpb, const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ rmax, const float* __restrict__ rsum,
                     const float* __restrict__ rdot, O* __restrict__ dk, O* __restrict__ dv) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.y * hpb, r1 = min(bh, r0 + hpb);
  for (int r = r0; r < r1; ++r) {
    __syncthreads();
    local_bwd_dkv_body<T, O, Body>(B, r, blockIdx.x * kKT, q, k, v, g, rmax, rsum, rdot, dk,
                                   dv, smem);
  }
}

template <class K>
int allow_smem(K kernel, size_t smem) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem)));
}

template <class T>
int fwd(Band B, int bh, const void* q, const void* k, const void* v, void* out,
        cudaStream_t s) {
  const size_t smem = sizeof(float) * (band_stage(B.w, 1) + G::kSmemFloats);
  auto kern = local_fwd_kernel<T>;
  if (int e = allow_smem(kern, smem)) return e;
  const dim3 grid((B.n + kQT - 1) / kQT, bh);
  kern<<<grid, kThreads, smem, s>>>(B, static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(out));
  return int(cudaGetLastError());
}

template <class T>
int bwd(Band B, int bh, const void* q, const void* k, const void* v, const void* g, void* dq,
        void* dk, void* dv, float* rmax, float* rsum, float* rdot, cudaStream_t s) {
  const size_t smem_dq = sizeof(float) * (band_stage(B.w, 2) + G::kSmemFloats);
  auto kdq = local_bwd_dq_kernel<T>;
  if (int e = allow_smem(kdq, smem_dq)) return e;
  const dim3 gq((B.n + kQT - 1) / kQT, bh);
  kdq<<<gq, kThreads, smem_dq, s>>>(B, static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<const T*>(g),
                                    static_cast<T*>(dq), rmax, rsum, rdot);
  if (int e = int(cudaGetLastError())) return e;
  const size_t smem_kv = sizeof(float) * (dkv_stage(B.d) + G::kSmemFloats);
  auto kkv = local_bwd_dkv_kernel<T>;
  if (int e = allow_smem(kkv, smem_kv)) return e;
  const dim3 gk((B.n + kKT - 1) / kKT, bh);
  kkv<<<gk, kThreads, smem_kv, s>>>(B, static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<const T*>(g), rmax,
                                    rsum, rdot, static_cast<T*>(dk), static_cast<T*>(dv));
  return int(cudaGetLastError());
}

template <class T, int Body>
int fwd_probe(Band B, int bh, int hpb, const void* q, const void* k, const void* v, void* out,
              cudaStream_t s) {
  const size_t smem = sizeof(float) * (band_stage(B.w, 1) + G::kSmemFloats);
  auto kern = probe_fwd_kernel<T, Body>;
  if (int e = allow_smem(kern, smem)) return e;
  const dim3 grid((B.n + kQT - 1) / kQT, (bh + hpb - 1) / hpb);
  kern<<<grid, kThreads, smem, s>>>(B, bh, hpb, static_cast<const T*>(q),
                                    static_cast<const T*>(k), static_cast<const T*>(v),
                                    static_cast<T*>(out));
  return int(cudaGetLastError());
}

template <class T>
int fwd_probe(int body, Band B, int bh, int hpb, const void* q, const void* k, const void* v,
              void* out, cudaStream_t s) {
  switch (body) {
    case FwdBody::kFoldScale: return fwd_probe<T, FwdBody::kFoldScale>(B, bh, hpb, q, k, v, out, s);
    case FwdBody::kFull: return fwd_probe<T, FwdBody::kFull>(B, bh, hpb, q, k, v, out, s);
    case FwdBody::kDefer: return fwd_probe<T, FwdBody::kDefer>(B, bh, hpb, q, k, v, out, s);
    case FwdBody::kNoMax: return fwd_probe<T, FwdBody::kNoMax>(B, bh, hpb, q, k, v, out, s);
    case FwdBody::kMatmuls: return fwd_probe<T, FwdBody::kMatmuls>(B, bh, hpb, q, k, v, out, s);
  }
  return int(cudaErrorInvalidValue);
}

template <class T, class O, int Body>
int bwd_probe(Band B, int bh, int hpb, const void* q, const void* k, const void* v,
              const void* g, void* dq, void* dk, void* dv, float* rmax, float* rsum,
              float* rdot, cudaStream_t s) {
  const size_t smem_dq = sizeof(float) * (band_stage(B.w, 2) + G::kSmemFloats);
  auto kdq = probe_bwd_dq_kernel<T, O, Body>;
  if (int e = allow_smem(kdq, smem_dq)) return e;
  const dim3 gq((B.n + kQT - 1) / kQT, (bh + hpb - 1) / hpb);
  kdq<<<gq, kThreads, smem_dq, s>>>(B, bh, hpb, static_cast<const T*>(q),
                                    static_cast<const T*>(k), static_cast<const T*>(v),
                                    static_cast<const T*>(g), static_cast<O*>(dq), rmax, rsum,
                                    rdot);
  if (int e = int(cudaGetLastError())) return e;
  const size_t smem_kv = sizeof(float) * (dkv_stage(B.d) + G::kSmemFloats);
  auto kkv = probe_bwd_dkv_kernel<T, O, Body>;
  if (int e = allow_smem(kkv, smem_kv)) return e;
  const dim3 gk((B.n + kKT - 1) / kKT, (bh + hpb - 1) / hpb);
  kkv<<<gk, kThreads, smem_kv, s>>>(B, bh, hpb, static_cast<const T*>(q),
                                    static_cast<const T*>(k), static_cast<const T*>(v),
                                    static_cast<const T*>(g), rmax, rsum, rdot,
                                    static_cast<O*>(dk), static_cast<O*>(dv));
  return int(cudaGetLastError());
}

template <class T, class O>
int bwd_probe(int body, Band B, int bh, int hpb, const void* q, const void* k, const void* v,
              const void* g, void* dq, void* dk, void* dv, float* rmax, float* rsum,
              float* rdot, cudaStream_t s) {
  switch (body) {
    case BwdBody::kFull:
      return bwd_probe<T, O, BwdBody::kFull>(B, bh, hpb, q, k, v, g, dq, dk, dv, rmax, rsum,
                                             rdot, s);
    case BwdBody::kMatmuls:
      return bwd_probe<T, O, BwdBody::kMatmuls>(B, bh, hpb, q, k, v, g, dq, dk, dv, rmax, rsum,
                                                rdot, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of the largest of the three kernels;
// the wrapper refuses windows whose band does not fit the card.
long long local_smem_bytes(int d, int w) {
  const long long a = sizeof(float) * (band_stage(w, 2) + G::kSmemFloats);
  const long long b = sizeof(float) * (dkv_stage(d) + G::kSmemFloats);
  return a > b ? a : b;
}

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t.
int local_fwd(int bh, int n, int d, int w, int dtype, float scale, const void* q,
              const void* k, const void* v, void* out, void* stream) {
  const Band B{n, d, w, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd<__nv_bfloat16>(B, bh, q, k, v, out, s)
                    : fwd<float>(B, bh, q, k, v, out, s);
}

// Two launches: dq (and the row statistics), then dk/dv.
int local_bwd(int bh, int n, int d, int w, int dtype, float scale, const void* q,
              const void* k, const void* v, const void* g, void* dq, void* dk, void* dv,
              float* rmax, float* rsum, float* rdot, void* stream) {
  const Band B{n, d, w, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? bwd<__nv_bfloat16>(B, bh, q, k, v, g, dq, dk, dv, rmax, rsum, rdot, s)
             : bwd<float>(B, bh, q, k, v, g, dq, dk, dv, rmax, rsum, rdot, s);
}

// The kernel-body probe (ops/kernel_body.py).  body: 0-4 = foldscale
// (the production forward's body), full, defer, nomax, matmuls; hpb:
// (batch·head) rows one block walks.  Same shared memory as local_fwd.
int local_fwd_probe(int body, int hpb, int bh, int n, int d, int w, int dtype, float scale,
                    const void* q, const void* k, const void* v, void* out, void* stream) {
  const Band B{n, d, w, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd_probe<__nv_bfloat16>(body, B, bh, hpb, q, k, v, out, s)
                    : fwd_probe<float>(body, B, bh, hpb, q, k, v, out, s);
}

// body: 0 = full (the production backward's body), 1 = matmuls; out_f32:
// dq, dk and dv written in f32 (else in the compute dtype).
int local_bwd_probe(int body, int hpb, int out_f32, int bh, int n, int d, int w, int dtype,
                    float scale, const void* q, const void* k, const void* v, const void* g,
                    void* dq, void* dk, void* dv, float* rmax, float* rsum, float* rdot,
                    void* stream) {
  const Band B{n, d, w, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return bwd_probe<float, float>(body, B, bh, hpb, q, k, v, g, dq, dk, dv, rmax, rsum, rdot, s);
  return out_f32 ? bwd_probe<__nv_bfloat16, float>(body, B, bh, hpb, q, k, v, g, dq, dk, dv,
                                                   rmax, rsum, rdot, s)
                 : bwd_probe<__nv_bfloat16, __nv_bfloat16>(body, B, bh, hpb, q, k, v, g, dq,
                                                           dk, dv, rmax, rsum, rdot, s);
}

}  // extern "C"
