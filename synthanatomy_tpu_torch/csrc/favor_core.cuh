// Row 5 on Hopper: causal FAVOR+ with fused feature maps, chunk-parallel.
//
// Replaces the TPU kernels of synthanatomy_tpu/ops/favor_pallas.py
// (_fwd_kernel :148, _bwd_dq_kernel :180, _bwd_dkv_kernel :218) for the
// shapes of favor_plan.h's route; the earlier one-block-per-(batch, head)
// kernels (favor_attention.cu) keep the rest.  Same math and rounding
// points as the plain twin (ops/favor_attention.py: favor_fwd_plain,
// favor_bwd_plain):
//   features  φ(x) = r·(exp(rnd(x·dn)·rnd(P)ᵀ − ‖x‖²dn²/2 − stab) + ε),
//             stab the row max over features for queries, 0 for keys;
//   forward   out = (rnd(tril(qc·kcᵀ))·v + qc·rnd(S)) / max(den, 1e-12),
//             den = Σ tril(qc·kcᵀ) + qc·rnd(z);
//   dq        rnd(ds)·kc + rnd(dnum)·rnd(S)ᵀ + gd·z through φ_q, the row
//             max's cotangent split evenly over ties;
//   dk/dv     the suffix (dS, dz) of the strictly later chunks.
//
// The TPU kernel carries the f32 state (S, z) in VMEM scratch along the
// sequential chunk axis of its grid.  Here the chunks run in parallel:
//   1. a state launch, one block per (batch·head, chunk, 64-row sub-tile,
//      side), writes the sub-tile's part of its chunk's own ΔS = kcᵀ·v,
//      Δz = Σ kp (the backward's query side ΔdS = qcᵀ·rnd(dnum), Δdz =
//      Σ qp·gd) and the features its rows give the consumers (rnd(kp),
//      rnd(qp), rnd(dnum), gd) to a workspace;
//   2. a scan launch adds the chunks' states in the sequential carry's
//      order (favor_plan.h: ascending for (S, z), descending for (dS, dz)),
//      exclusive, and writes rnd(S) in T beside z in f32;
//   3. consumer launches, one block per (batch·head, chunk, 64-row
//      sub-tile): the forward (out, den), dq and dk/dv.
// No atomics: every sum has a fixed order, so two runs give identical bits.
//
// Products in bf16 run on the tensor cores (mma.sync m16n8k16, ldmatrix
// fragments, band_attention.cuh's helpers); f32 inputs take FMAs in the
// same fragment layout.  A block is one warpgroup, warp w owning rows 16w
// .. 16w + 15 of the block's 64-row sub-tile; a warp holds a row's
// accumulators across all mp features (16 × mp f32, 128 registers at m
// 256), so the features' row max, the tie routing and w = Σ_f dE stay in
// registers.  Tiles are staged by 16-byte cp.async, zero past the
// sequence's rows, the head's 64 padded columns and the mp padded
// features, and masked where that is not enough (row max, ties, kp and qp
// past m or past the chunk).
//
// What bounds it: 39 GFLOP of products a layer fwd+bwd at the paper shape
// (B6 × 8 heads, L 1400, chunk 128, m 256, d 64; chip_smoke.py's
// _favor_flops), so operations; the design keeps every product on the
// tensor cores and puts 1056 blocks (2112 in the backward's state launch)
// on 132 SMs, two an SM.  What holds it above that bound is traffic
// through L2: the chunk states, features and P that the launches hand on
// (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "band_attention.cuh"
#include "favor_plan.h"

namespace fv {

using band::acc_col;
using band::acc_row;
using band::lane;
using band::quad_max;
using band::quad_sum;
using frag::cp_async16;
using frag::cp_async4;
using frag::cp_commit;
using frag::cp_wait;
using sa::from_f;
using sa::rnd;
using sa::to_f;

static_assert(fp::kSub == band::kTile && fp::kThreads == band::kThreads, "one warpgroup a block");

constexpr int kSub = fp::kSub;
constexpr int kThreads = fp::kThreads;
constexpr int DP = fp::kDP;
constexpr float kEps = 1e-4f;  // the feature map's epsilon

// a·b − c·e·f, each product rounded as the plain version rounds it (no
// contraction into an FMA): dq and dk are such differences of terms far
// larger than themselves, so one rounding more or less shows
__device__ __forceinline__ float sub_products(float a, float b, float c, float e, float f) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(__fmul_rn(c, e), f));
}

// Bodies of the kernel-body probe (ops/kernel_body.py, favor_probe.cuh),
// compile-time ablations; production is kFull.  kIdFeat: the features are the raw
// products U = x·rnd(P)ᵀ (no d^-1/4 scale, no diag, max or exp; the
// backward's chain through φ runs with e = U, the tie routing on U);
// kNoMask: a row sees every row of its chunk (no causal select).
namespace FavorBody {
enum { kFull = 0, kIdFeat, kNoMask };
}

// Everything a launch reads: shapes, constants, tensors, workspace.
struct Args {
  int bh, n, d, m, chunk, nc;
  float dn, half_dn2, dn2, r;  // d^-1/4, dn²/2, dn², m^-1/2 (from the host, in f32)
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* P;    // (m, d) f32
  const float* out;  // (bh, n, d) f32 (backward)
  const float* den;  // (bh, n) f32 (backward)
  float* o_out;      // (bh, n, d) f32 outputs, each where its launch writes it
  float* o_den;      // (bh, n) f32
  float* o_dq;
  float* o_dk;
  float* o_dv;
  unsigned char* work;
  long long off[fp::kArrays];  // byte offsets of the workspace arrays
};

template <class T>
__host__ __device__ constexpr int ld(int cols) {
  return fp::row_ld(int(sizeof(T)), cols);
}

template <class U>
__device__ __forceinline__ U* array(const Args& A, int a) {
  return reinterpret_cast<U*>(A.work + A.off[a]);
}

// region R of launch Kind's shared memory (favor_plan.h), for inputs of
// type T, as an array of U (the offset is a compile-time constant)
template <class T, int MP, int Kind, int R, class U = T>
__device__ __forceinline__ U* region(unsigned char* smem) {
  constexpr int off = fp::region_offset(Kind, R, int(sizeof(T)), MP);
  return reinterpret_cast<U*>(smem + off);
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// Rows [0, rows) of a row-major (·, cols) tensor from src into a [ROWS][COLS]
// tile (row stride ld<T>(COLS)); zeros past rows and past cols.  16-byte
// cp.async (cols·sizeof(T) a multiple of 16), committed by the caller.
template <class T, int ROWS, int COLS>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int rows, int cols) {
  constexpr int per = 16 / int(sizeof(T)), chunks = COLS / per;
  for (int e = threadIdx.x; e < ROWS * chunks; e += kThreads) {
    const int r = e / chunks, c = (e % chunks) * per;
    const bool ok = r < rows && c < cols;
    cp_async16(dst + r * ld<T>(COLS) + c, ok ? src + (long long)r * cols + c : src, ok);
  }
}

// `count` floats (zeros up to `total`)
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src, int count,
                                          int total) {
  for (int i = threadIdx.x; i < total; i += kThreads) cp_async4(dst + i, i < count ? src + i : src, i < count);
}

// rnd(P) into an [MP][DP] tile: zeros past m features and d columns
// (plain loads: P is f32 and the products take it rounded to T), eight
// 16-byte loads in flight a thread
template <class T, int MP>
__device__ __forceinline__ void stage_proj(T* dst, const float* __restrict__ P, int m, int d) {
  constexpr int kIters = MP * DP / 4 / kThreads, kBatch = 8;
  static_assert(kIters % kBatch == 0, "whole batches of loads");
#pragma unroll 1
  for (int i0 = 0; i0 < kIters; i0 += kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = threadIdx.x + (i0 + i) * kThreads, f = e / (DP / 4), c = (e % (DP / 4)) * 4;
      x[i] = f < m && c < d ? *reinterpret_cast<const float4*>(P + (long long)f * d + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = threadIdx.x + (i0 + i) * kThreads, f = e / (DP / 4), c = (e % (DP / 4)) * 4;
      T* o = dst + f * ld<T>(DP) + c;
      o[0] = from_f<T>(x[i].x);
      o[1] = from_f<T>(x[i].y);
      o[2] = from_f<T>(x[i].z);
      o[3] = from_f<T>(x[i].w);
    }
  }
}

// A staged x tile (k or q) in place: diag[r] = ‖x_r‖²·dn²/2 from the raw
// values, then x_r ← rnd(x_r·dn) (kIdFeat: x_r as it is).  Ends with a
// barrier.
template <class T, int Body>
__device__ __forceinline__ void scale_rows(T* X, float* diag, const Args& A) {
  const int l = lane();
  for (int r = threadIdx.x >> 5; r < kSub; r += kThreads / 32) {
    T* row = X + r * ld<T>(DP);
    float s = 0.f;
    for (int c = l; c < DP; c += 32) {
      const float x = to_f(row[c]);
      s += x * x;
    }
    s = sa::warp_sum(s);
    if (l == 0) diag[r] = s * A.half_dn2;
    if constexpr (Body != FavorBody::kIdFeat)
      for (int c = l; c < DP; c += 32) row[c] = from_f<T>(to_f(row[c]) * A.dn);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// products (band_attention.cuh's layout: a warp's 16 rows by 8·NB columns)
// ---------------------------------------------------------------------------

template <class T, int K>
using Rows = band::TileRows<T, K, false>;

// acc (16 x 8·NB) = X rows · P[f0, f0 + 8·NB)ᵀ: the dash U of the warp's rows
template <class T, int NB>
__device__ __forceinline__ void dash(float (&acc)[NB][4], const Rows<T, DP>& x, const T* P, int f0) {
  band::zero(acc);
  band::rows_rows<T, DP, false, NB>(acc, x, P + f0 * ld<T>(DP));
}

// acc (16 x 8·NB) += A (16 x K, staged rows) · B, B (K x 8·NB) staged with
// row stride ldb and read down its rows (qc·rnd(S), kc·rnd(dS))
template <class T, int K, int NB>
__device__ __forceinline__ void rows_cols(float (&acc)[NB][4], const Rows<T, K>& a, const T* b,
                                          int ldb) {
  const int l = lane();
  if constexpr (band::kTensorCores<T>) {
#pragma unroll 4
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t af[4];
      a.frag(ks, af);
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        uint32_t bf[4];
        frag::ldsm4_t(bf, b + (16 * ks + (l & 7) + ((l >> 3) & 1) * 8) * ldb + 16 * p + (l >> 4) * 8);
        frag::mma(acc[2 * p], af, bf[0], bf[1]);
        frag::mma(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    constexpr int lda = ld<T>(K);
    const int g = l >> 2, t = l & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = a.p[g * lda + k], a1 = a.p[(g + 8) * lda + k];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float b0 = b[k * ldb + 8 * nb + 2 * t], b1 = b[k * ldb + 8 * nb + 2 * t + 1];
        acc[nb][0] = fmaf(a0, b0, acc[nb][0]);
        acc[nb][1] = fmaf(a0, b1, acc[nb][1]);
        acc[nb][2] = fmaf(a1, b0, acc[nb][2]);
        acc[nb][3] = fmaf(a1, b1, acc[nb][3]);
      }
    }
  }
}

// the 64-column-block row sums of acc for rows g (s[0]) and g + 8 (s[1]),
// over the quad that holds the row
template <int NB>
__device__ __forceinline__ void row_sums(const float (&acc)[NB][4], float (&s)[2]) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    a += acc[nb][0] + acc[nb][1];
    b += acc[nb][2] + acc[nb][3];
  }
  s[0] += quad_sum(a);
  s[1] += quad_sum(b);
}

// Column sums over the warp's 16 rows of acc·(row weight wr), for columns
// f0 + 8·nb + 2t, +1, into zpart[f] (lanes 0-3 write).
template <int NB>
__device__ __forceinline__ void col_sums(const float (&acc)[NB][4], const float (&wr)[2],
                                         float* zpart, int f0) {
  const int l = lane();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = acc[nb][c] * wr[0] + acc[nb][2 + c] * wr[1];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (l < 4) zpart[f0 + 8 * nb + 2 * l + c] = s;
    }
}

// acc in the accumulator layout, rounded to T, into rows of a [64][cols]
// tile from `dst` (the warp's first row)
template <class T, int NB>
__device__ __forceinline__ void store_tile(T* dst, int ldd, const float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) dst[acc_row(r) * ldd + acc_col(nb, r)] = from_f<T>(acc[nb][r]);
}

// acc·(s0 for row g, s1 for row g + 8), f32, into rows [0, rows) and
// columns [0, cols) of a row-major (·, cols) f32 tensor from dst (the
// warp's first row); cols even, so a lane's two adjacent columns go out
// as one 8-byte store
template <int NB>
__device__ __forceinline__ void store_f32(float* dst, int rows, int cols, const float (&acc)[NB][4],
                                          float s0 = 1.f, float s1 = 1.f) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = acc_row(2 * h), c = acc_col(nb, 0);
      const float sc = h ? s1 : s0;
      if (i < rows && c < cols)
        *reinterpret_cast<float2*>(dst + (long long)i * cols + c) =
            make_float2(acc[nb][2 * h] * sc, acc[nb][2 * h + 1] * sc);
    }
}

// rows [0, rows) of a staged [64][COLS] tile into a row-major (·, COLS)
// tensor, 16 bytes a thread
template <class T, int COLS>
__device__ __forceinline__ void copy_rows(T* dst, const T* tile, int rows) {
  constexpr int per = 16 / int(sizeof(T)), chunks = COLS / per;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, c = (e % chunks) * per;
    *reinterpret_cast<uint4*>(dst + (long long)r * COLS + c) =
        *reinterpret_cast<const uint4*>(tile + r * ld<T>(COLS) + c);
  }
}

// ---------------------------------------------------------------------------
// feature maps (in the accumulator layout, columns from f0)
// ---------------------------------------------------------------------------

// key features in place: r·(exp(U − diag) + ε) (kIdFeat: U); zero past m
// features and past `rows` rows
template <int Body, int NB>
__device__ __forceinline__ void key_features(float (&u)[NB][4], const float (&diag)[2], int f0,
                                             int rows, const Args& A) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool ok = f0 + acc_col(nb, r) < A.m && acc_row(r) < rows;
      float x = u[nb][r];
      if constexpr (Body != FavorBody::kIdFeat) x = A.r * (expf(x - diag[r >> 1]) + kEps);
      u[nb][r] = ok ? x : 0.f;
    }
}

// the row max of U over the m real features, for rows g (mx[0]) and g + 8
template <int NB>
__device__ __forceinline__ void row_max(const float (&u)[NB][4], int f0, int m, float (&mx)[2]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (f0 + acc_col(nb, r) < m) mx[r >> 1] = fmaxf(mx[r >> 1], u[nb][r]);
}

// query features in place: r·(exp(U − diag − max) + ε) (kIdFeat: U)
template <int Body, int NB>
__device__ __forceinline__ void query_features(float (&u)[NB][4], const float (&diag)[2],
                                               const float (&mx)[2], int rows, const Args& A) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool ok = acc_col(nb, r) < A.m && acc_row(r) < rows;
      float x = u[nb][r];
      if constexpr (Body != FavorBody::kIdFeat)
        x = A.r * (expf(x - diag[r >> 1] - mx[r >> 1]) + kEps);
      u[nb][r] = ok ? x : 0.f;
    }
}

// the causal select of a diagonal sub-tile pair: rows (the warp's 16 from
// row0) see columns ≤ themselves (keys_are_rows: rows are keys, columns
// queries, which see rows ≤ themselves)
template <int NB>
__device__ __forceinline__ void causal(float (&acc)[NB][4], int row0, bool keys_are_rows) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = row0 + acc_row(r), j = acc_col(nb, r);
      if (keys_are_rows ? j < i : j > i) acc[nb][r] = 0.f;
    }
}

// ---------------------------------------------------------------------------
// 1. the state launch
// ---------------------------------------------------------------------------

// One side of a 64-row sub-tile s of chunk c: keys (Queries false: kc →
// kKC, its part of ΔS = kcᵀ·v and Δz = Σ kp into kDelta0) or queries (qc
// → kQC, rnd(dnum) → kDN, gd → kGD, its part of ΔdS = qcᵀ·rnd(dnum) and
// Δdz = Σ qp·gd into kDelta1).  The scan adds a chunk's sub-tile parts in
// sub-tile order.
template <class T, int MP, int Body, bool Queries>
__device__ __forceinline__ void state_side(const Args& A, unsigned char* smem, int c, int s,
                                           int bh) {
  T* sP = region<T, MP, fp::kState, 0>(smem);
  T* sX = region<T, MP, fp::kState, 1>(smem);
  T* sY = region<T, MP, fp::kState, 2>(smem);
  T* sXC = region<T, MP, fp::kState, 3>(smem);
  float* diag = region<T, MP, fp::kState, 4, float>(smem);
  float* gd = diag + kSub;
  float* den = gd + kSub;
  float* zpart = den + kSub;  // [4][MP]
  float* sO = region<T, MP, fp::kState, 5, float>(smem);
  const int n = A.n, d = A.d, ch = A.chunk, w = threadIdx.x >> 5;
  const int c0 = c * ch, cl = fp::chunk_rows(c, n, ch);
  const long long row0 = (long long)bh * n + c0;  // the chunk's first row of (bh, n)
  const T* x = static_cast<const T*>(Queries ? A.q : A.k) + row0 * d;
  const T* y = static_cast<const T*>(Queries ? A.g : A.v) + row0 * d;
  T* feat = array<T>(A, Queries ? fp::kQC : fp::kKC) + row0 * MP;
  float* delta = array<float>(A, Queries ? fp::kDelta1 : fp::kDelta0) +
                 (((long long)bh * A.nc + c) * fp::subs(ch) + s) * fp::state_floats(MP);
  const int r0 = s * kSub, rows = min(kSub, cl - r0);
  stage<T, kSub, DP>(sX, x + (long long)r0 * d, rows, d);
  stage<T, kSub, DP>(sY, y + (long long)r0 * d, rows, d);
  if constexpr (Queries) {
    stage<float, kSub, DP>(sO, A.out + (row0 + r0) * d, rows, d);
    stage_f32(den, A.den + row0 + r0, rows, kSub);
  }
  cp_commit();
  stage_proj<T, MP>(sP, A.P, A.m, d);  // while the tiles' copies are in flight
  cp_wait<0>();
  __syncthreads();
  scale_rows<T, Body>(sX, diag, A);
  if constexpr (Queries) {
    // the output cotangent, one warp a row: inv = 1/max(den, 1e-12),
    // gd = −(Σ g·out)·inv, Y ← rnd(g·inv) (kept as dnum's rows, and in kDN)
    const int l = lane();
    for (int i = w; i < kSub; i += kThreads / 32) {
      T* row = sY + i * ld<T>(DP);
      const float* orow = sO + i * ld<float>(DP);
      float inv = 0.f, sum = 0.f;
      if (i < rows) {
        inv = 1.f / fmaxf(den[i], 1e-12f);
        for (int e = l; e < d; e += 32) sum += __fmul_rn(to_f(row[e]), orow[e]);
      }
      sum = sa::warp_sum(sum);
      for (int e = l; e < DP; e += 32) row[e] = from_f<T>(to_f(row[e]) * inv);
      if (l == 0) gd[i] = i < rows ? -sum * inv : 0.f;
    }
    __syncthreads();
    T* dn = array<T>(A, fp::kDN) + (row0 + r0) * DP;
    float* gdw = array<float>(A, fp::kGD) + row0 + r0;
    copy_rows<T, DP>(dn, sY, rows);
    for (int i = threadIdx.x; i < rows; i += kThreads) gdw[i] = gd[i];
  }
  // features of the warp's 16 rows across all MP columns
  {
    Rows<T, DP> xr;
    xr.init(sX + 16 * w * ld<T>(DP));
    float u[MP / 8][4];
    dash<T, MP / 8>(u, xr, sP, 0);
    const int wrows = rows - 16 * w;
    const float dg[2] = {diag[16 * w + acc_row(0)], diag[16 * w + acc_row(2)]};
    float wr[2] = {1.f, 1.f};
    if constexpr (Queries) {
      float mx[2] = {-INFINITY, -INFINITY};
      row_max(u, 0, A.m, mx);
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
      query_features<Body>(u, dg, mx, wrows, A);
      wr[0] = gd[16 * w + acc_row(0)];
      wr[1] = gd[16 * w + acc_row(2)];
    } else {
      key_features<Body>(u, dg, 0, wrows, A);
    }
    col_sums(u, wr, zpart + w * MP, 0);
    store_tile<T>(sXC + 16 * w * ld<T>(MP), ld<T>(MP), u);
  }
  __syncthreads();
  copy_rows<T, MP>(feat + (long long)r0 * MP, sXC, rows);
  // Δ = XCᵀ · Y: warp w owns feature groups w, w + 4, … of 16
  for (int fg = w; fg < MP / 16; fg += kThreads / 32) {
    float acc[DP / 8][4];
    band::zero(acc);
    band::cols_cols<T, DP, DP / 8>(acc, sXC, ld<T>(MP), 16 * fg, sY);
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(delta + (16 * fg + acc_row(2 * h)) * DP + acc_col(nb, 0)) =
            make_float2(acc[nb][2 * h], acc[nb][2 * h + 1]);
  }
  for (int f = threadIdx.x; f < MP; f += kThreads)
    delta[MP * DP + f] = ((zpart[f] + zpart[MP + f]) + zpart[2 * MP + f]) + zpart[3 * MP + f];
}

// grid (sides · subs(chunk), nc, bh): sub-tile blockIdx.x % subs of chunk
// blockIdx.y, its keys (side 0) or, with Bwd, its queries (side 1)
template <class T, int MP, int Body, bool Bwd>
__global__ void __launch_bounds__(kThreads) favor_state_kernel(Args A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int subs = fp::subs(A.chunk), s = blockIdx.x % subs, c = blockIdx.y, bh = blockIdx.z;
  if (fp::sub_rows(c, s, A.n, A.chunk) <= 0) return;
  if (Bwd && blockIdx.x >= subs) state_side<T, MP, Body, true>(A, smem, c, s, bh);
  else state_side<T, MP, Body, false>(A, smem, c, s, bh);
}

// ---------------------------------------------------------------------------
// 2. the scan
// ---------------------------------------------------------------------------

// grid (⌈state_floats/1024⌉, bh, directions): each thread four adjacent
// elements of the state (16-byte loads), over the chunks in the
// direction's order (favor_plan.h); the chunk is handed the sum of those
// visited before it (exclusive), S as T into kST, z as f32 into kZF; then
// its own Δ, the sum of its sub-tiles' parts in sub-tile order, joins the
// carry.
template <class T>
__global__ void __launch_bounds__(fp::kScanThreads) favor_scan_kernel(Args A, int mp) {
  const int dir = blockIdx.z, bh = blockIdx.y, sf = fp::state_floats(mp);
  const int e = 4 * (blockIdx.x * fp::kScanThreads + threadIdx.x);
  if (e >= sf) return;
  const int subs = fp::subs(A.chunk);
  const bool is_s = e < mp * DP;  // four elements of S, or four of z
  const long long base = (long long)bh * A.nc;
  const float* delta = array<float>(A, dir ? fp::kDelta1 : fp::kDelta0) + base * subs * sf + e;
  T* st = array<T>(A, dir ? fp::kST1 : fp::kST0) + base * mp * DP + e;
  float* zf = array<float>(A, dir ? fp::kZF1 : fp::kZF0) + base * mp + (e - mp * DP);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int step = 0; step < A.nc; ++step) {
    const int c = fp::scan_chunk(step, A.nc, dir);
    if (is_s) {
      T* o = st + (long long)c * mp * DP;
      o[0] = from_f<T>(acc.x);
      o[1] = from_f<T>(acc.y);
      o[2] = from_f<T>(acc.z);
      o[3] = from_f<T>(acc.w);
    } else {
      *reinterpret_cast<float4*>(zf + (long long)c * mp) = acc;
    }
    float4 own = *reinterpret_cast<const float4*>(delta + (long long)c * subs * sf);
    for (int s = 1; s < subs && fp::sub_rows(c, s, A.n, A.chunk) > 0; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(delta + ((long long)c * subs + s) * sf);
      own.x += x.x;
      own.y += x.y;
      own.z += x.z;
      own.w += x.w;
    }
    acc.x += own.x;
    acc.y += own.y;
    acc.z += own.z;
    acc.w += own.w;
  }
}

// ---------------------------------------------------------------------------
// 3. the consumers, grid (subs(chunk), nc, bh)
// ---------------------------------------------------------------------------

// the key (or query) sub-tiles a sub-tile's rows see within its chunk
template <int Body>
__device__ __forceinline__ int walk_end(int sub, int cl) {
  return Body == FavorBody::kNoMask ? (cl + kSub - 1) / kSub : sub + 1;
}

// out = (rnd(tril(qc·kcᵀ))·v + qc·rnd(S)) / max(den, 1e-12)
template <class T, int MP, int Body>
__global__ void __launch_bounds__(kThreads) favor_fwd_kernel(Args A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sub = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, w = threadIdx.x >> 5;
  const int n = A.n, d = A.d, ch = A.chunk;
  const int rows = fp::sub_rows(c, sub, n, ch);
  if (rows <= 0) return;
  const int c0 = c * ch, cl = fp::chunk_rows(c, n, ch), q0 = sub * kSub;
  const long long crow = (long long)bh * n + c0;  // the chunk's first row
  T* sPS = region<T, MP, fp::kFwd, 0>(smem);  // P, then S
  T* sQC = region<T, MP, fp::kFwd, 1>(smem);
  T* sKC = region<T, MP, fp::kFwd, 2>(smem);
  T* sXV = region<T, MP, fp::kFwd, 3>(smem);  // q, then v
  float* diag = region<T, MP, fp::kFwd, 4, float>(smem);

  stage<T, kSub, DP>(sXV, static_cast<const T*>(A.q) + (crow + q0) * d, rows, d);
  cp_commit();
  stage_proj<T, MP>(sPS, A.P, A.m, d);
  cp_wait<0>();
  __syncthreads();
  scale_rows<T, Body>(sXV, diag, A);

  const int wrows = rows - 16 * w;
  float den[2] = {0.f, 0.f};
  {
    Rows<T, DP> xr;
    xr.init(sXV + 16 * w * ld<T>(DP));
    float u[MP / 8][4];
    dash<T, MP / 8>(u, xr, sPS, 0);
    float mx[2] = {-INFINITY, -INFINITY};
    row_max(u, 0, A.m, mx);
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float dg[2] = {diag[16 * w + acc_row(0)], diag[16 * w + acc_row(2)]};
    query_features<Body>(u, dg, mx, wrows, A);
    // qc·rnd(z), summed in f32 (kept apart from the scores' sum, as the
    // plain version adds the two)
    const float* z = array<float>(A, fp::kZF0) + ((long long)bh * A.nc + c) * MP;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int nb = 0; nb < MP / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float t = __fmul_rn(rnd<T>(u[nb][r]), rnd<T>(z[acc_col(nb, r)]));
        if (r < 2) a += t;
        else b += t;
      }
    den[0] = quad_sum(a);
    den[1] = quad_sum(b);
    store_tile<T>(sQC + 16 * w * ld<T>(MP), ld<T>(MP), u);
  }
  __syncthreads();  // P and q are dead

  stage<T, MP, DP>(sPS, array<T>(A, fp::kST0) + ((long long)bh * A.nc + c) * MP * DP, MP, DP);
  cp_commit();
  Rows<T, MP> qcr;
  qcr.init(sQC + 16 * w * ld<T>(MP));
  float num[DP / 8][4];
  band::zero(num);
  float ssum[2] = {0.f, 0.f};
  const int kend = walk_end<Body>(sub, cl);
  for (int kt = 0; kt < kend; ++kt) {
    const int krows = min(kSub, cl - kt * kSub);
    stage<T, kSub, MP>(sKC, array<T>(A, fp::kKC) + (crow + kt * kSub) * MP, krows, MP);
    stage<T, kSub, DP>(sXV, static_cast<const T*>(A.v) + (crow + kt * kSub) * d, krows, d);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    float s[kSub / 8][4];
    band::zero(s);
    band::rows_rows<T, MP, false, kSub / 8>(s, qcr, sKC);
    if (Body != FavorBody::kNoMask && kt == sub) causal(s, 16 * w, false);
    row_sums(s, ssum);
    band::acc_cols<T, DP, kSub / 8, DP / 8>(num, s, sXV);
    __syncthreads();
  }
  rows_cols<T, MP, DP / 8>(num, qcr, sPS, ld<T>(DP));
  den[0] = ssum[0] + den[0];  // den = Σ scores + qc·rnd(z)
  den[1] = ssum[1] + den[1];
  store_f32(A.o_out + (crow + q0 + 16 * w) * d, wrows, d, num, 1.f / fmaxf(den[0], 1e-12f),
            1.f / fmaxf(den[1], 1e-12f));
  float* dn = A.o_den + crow + q0 + 16 * w;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (acc_row(2 * h) < wrows && (lane() & 3) == 0) dn[acc_row(2 * h)] = den[h];
}


// dq = rnd(du)·rnd(P)·dn − w·dn²·q, du from dq_p = (rnd(ds)·kc +
// rnd(dnum)·rnd(S)ᵀ) + gd·z through φ_q, summed in the plain version's
// grouping (the small terms first, the large gd·z last)
template <class T, int MP, int Body>
__global__ void __launch_bounds__(kThreads) favor_dq_kernel(Args A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sub = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, w = threadIdx.x >> 5;
  const int n = A.n, d = A.d, ch = A.chunk;
  const int rows = fp::sub_rows(c, sub, n, ch);
  if (rows <= 0) return;
  const int c0 = c * ch, cl = fp::chunk_rows(c, n, ch), q0 = sub * kSub;
  const long long crow = (long long)bh * n + c0, st = (long long)bh * A.nc + c;
  T* sP = region<T, MP, fp::kDq, 0>(smem);
  T* sSK = region<T, MP, fp::kDq, 1>(smem);  // kc, then S
  T* sV = region<T, MP, fp::kDq, 2>(smem);
  T* sQ = region<T, MP, fp::kDq, 3>(smem);
  T* sDN = region<T, MP, fp::kDq, 4>(smem);
  float* diag = region<T, MP, fp::kDq, 5, float>(smem);
  float* gd = diag + kSub;
  float* zf = gd + kSub;

  stage<T, kSub, DP>(sQ, static_cast<const T*>(A.q) + (crow + q0) * d, rows, d);
  stage<T, kSub, DP>(sDN, array<T>(A, fp::kDN) + (crow + q0) * DP, rows, DP);
  stage_f32(gd, array<float>(A, fp::kGD) + crow + q0, rows, kSub);
  stage_f32(zf, array<float>(A, fp::kZF0) + st * MP, MP, MP);
  cp_commit();
  stage_proj<T, MP>(sP, A.P, A.m, d);
  cp_wait<0>();
  __syncthreads();
  scale_rows<T, Body>(sQ, diag, A);

  const int wrows = rows - 16 * w;
  const float gdr[2] = {gd[16 * w + acc_row(0)], gd[16 * w + acc_row(2)]};
  Rows<T, DP> dnr;
  dnr.init(sDN + 16 * w * ld<T>(DP));
  float dqp[MP / 8][4];
  band::zero(dqp);
  const int kend = walk_end<Body>(sub, cl);
  for (int kt = 0; kt < kend; ++kt) {
    const int krows = min(kSub, cl - kt * kSub);
    stage<T, kSub, MP>(sSK, array<T>(A, fp::kKC) + (crow + kt * kSub) * MP, krows, MP);
    stage<T, kSub, DP>(sV, static_cast<const T*>(A.v) + (crow + kt * kSub) * d, krows, d);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    float ds[kSub / 8][4];
    band::zero(ds);
    band::rows_rows<T, DP, false, kSub / 8>(ds, dnr, sV);  // rnd(dnum)·vᵀ
#pragma unroll
    for (int nb = 0; nb < kSub / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[nb][r] += gdr[r >> 1];
    if (Body != FavorBody::kNoMask && kt == sub) causal(ds, 16 * w, false);
    band::acc_cols<T, MP, kSub / 8, MP / 8>(dqp, ds, sSK);  // += rnd(ds)·kc
    __syncthreads();
  }
  stage<T, MP, DP>(sSK, array<T>(A, fp::kST0) + st * MP * DP, MP, DP);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  band::rows_rows<T, DP, false, MP / 8>(dqp, dnr, sSK);  // += rnd(dnum)·rnd(S)ᵀ
#pragma unroll
  for (int nb = 0; nb < MP / 8; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) dqp[nb][r] += __fmul_rn(gdr[r >> 1], zf[acc_col(nb, r)]);

  // through φ_q: dE = dq_p·(r·e_q), w = Σ_f dE, and the row max's
  // cotangent −w split evenly over the tied maxima; U is recomputed in
  // 64-feature slices, first for the max, then for e_q and the ties
  Rows<T, DP> xr;
  xr.init(sQ + 16 * w * ld<T>(DP));
  const float dg[2] = {diag[16 * w + acc_row(0)], diag[16 * w + acc_row(2)]};
  float mx[2] = {-INFINITY, -INFINITY};
  for (int fs = 0; fs < MP / 64; ++fs) {
    float u[8][4];
    dash<T, 8>(u, xr, sP, 64 * fs);
    row_max(u, 64 * fs, A.m, mx);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float wsum[2] = {0.f, 0.f}, cnt[2] = {0.f, 0.f};
  uint32_t tie[MP / 64];
#pragma unroll
  for (int fs = 0; fs < MP / 64; ++fs) {
    float u[8][4];
    dash<T, 8>(u, xr, sP, 64 * fs);
    tie[fs] = 0u;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = 64 * fs + acc_col(nb, r) < A.m;
        const float e = Body == FavorBody::kIdFeat ? u[nb][r]
                                                   : expf(u[nb][r] - dg[r >> 1] - mx[r >> 1]);
        const float de = ok ? dqp[8 * fs + nb][r] * (A.r * e) : 0.f;
        dqp[8 * fs + nb][r] = de;
        wsum[r >> 1] += de;
        if (ok && u[nb][r] == mx[r >> 1]) {
          tie[fs] |= 1u << (4 * nb + r);
          cnt[r >> 1] += 1.f;
        }
      }
  }
  float share[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wsum[h] = quad_sum(wsum[h]);
    share[h] = wsum[h] / quad_sum(cnt[h]);
  }
#pragma unroll
  for (int fs = 0; fs < MP / 64; ++fs)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if ((tie[fs] >> (4 * nb + r)) & 1u) dqp[8 * fs + nb][r] -= share[r >> 1];
  float dq[DP / 8][4];
  band::zero(dq);
  band::acc_cols<T, DP, MP / 8, DP / 8>(dq, dqp, sP);  // rnd(du)·rnd(P)
  const T* q = static_cast<const T*>(A.q) + (crow + q0 + 16 * w) * d;
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = acc_row(r), e = acc_col(nb, r);
      if (i < wrows && e < d)
        dq[nb][r] = sub_products(dq[nb][r], A.dn, wsum[r >> 1], A.dn2, to_f(q[(long long)i * d + e]));
    }
  store_f32(A.o_dq + (crow + q0 + 16 * w) * d, wrows, d, dq);
}

// dv = rnd(scores)ᵀ·rnd(dnum) + kc·rnd(dS); dk = rnd(dE)·rnd(P)·dn −
// w·dn²·k, dE from dk_p = rnd(ds)ᵀ·qc + v·rnd(dS)ᵀ + dz through φ_k, with
// (dS, dz) the strictly later chunks' (the reverse scan is exclusive)
template <class T, int MP, int Body>
__global__ void __launch_bounds__(kThreads) favor_dkv_kernel(Args A) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sub = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, w = threadIdx.x >> 5;
  const int n = A.n, d = A.d, ch = A.chunk;
  const int rows = fp::sub_rows(c, sub, n, ch);
  if (rows <= 0) return;
  const int c0 = c * ch, cl = fp::chunk_rows(c, n, ch), k0 = sub * kSub;
  const long long crow = (long long)bh * n + c0, st = (long long)bh * A.nc + c;
  T* sR = region<T, MP, fp::kDkv, 0>(smem);  // qc, then dS, then P
  T* sKC = region<T, MP, fp::kDkv, 1>(smem);
  T* sV = region<T, MP, fp::kDkv, 2>(smem);
  T* sX = region<T, MP, fp::kDkv, 3>(smem);  // dnum, then k
  float* gd = region<T, MP, fp::kDkv, 4, float>(smem);
  float* diag = gd + kSub;
  float* dz = diag + kSub;

  stage<T, kSub, MP>(sKC, array<T>(A, fp::kKC) + (crow + k0) * MP, rows, MP);
  stage<T, kSub, DP>(sV, static_cast<const T*>(A.v) + (crow + k0) * d, rows, d);
  cp_commit();
  const int wrows = rows - 16 * w;
  Rows<T, MP> kcr;
  kcr.init(sKC + 16 * w * ld<T>(MP));
  Rows<T, DP> vr;
  vr.init(sV + 16 * w * ld<T>(DP));
  float dkp[MP / 8][4], dv[DP / 8][4];
  band::zero(dkp);
  band::zero(dv);
  const int ib = Body == FavorBody::kNoMask ? 0 : sub, ie = (cl + kSub - 1) / kSub;
  for (int it = ib; it < ie; ++it) {
    const int qrows = min(kSub, cl - it * kSub);
    stage<T, kSub, MP>(sR, array<T>(A, fp::kQC) + (crow + it * kSub) * MP, qrows, MP);
    stage<T, kSub, DP>(sX, array<T>(A, fp::kDN) + (crow + it * kSub) * DP, qrows, DP);
    stage_f32(gd, array<float>(A, fp::kGD) + crow + it * kSub, qrows, kSub);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    const bool diag_pair = Body != FavorBody::kNoMask && it == sub;
    float s[kSub / 8][4];  // keys x queries: scoresᵀ
    band::zero(s);
    band::rows_rows<T, MP, false, kSub / 8>(s, kcr, sR);
    if (diag_pair) causal(s, 16 * w, true);
    band::acc_cols<T, DP, kSub / 8, DP / 8>(dv, s, sX);  // += rnd(scores)ᵀ·rnd(dnum)
    band::zero(s);
    band::rows_rows<T, DP, false, kSub / 8>(s, vr, sX);  // dsᵀ = v·rnd(dnum)ᵀ + gd
#pragma unroll
    for (int nb = 0; nb < kSub / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nb][r] += gd[acc_col(nb, r)];
    if (diag_pair) causal(s, 16 * w, true);
    band::acc_cols<T, MP, kSub / 8, MP / 8>(dkp, s, sR);  // += rnd(ds)ᵀ·qc
    __syncthreads();
  }

  // the suffix (dS, dz) of the later chunks
  stage<T, MP, DP>(sR, array<T>(A, fp::kST1) + st * MP * DP, MP, DP);
  stage_f32(dz, array<float>(A, fp::kZF1) + st * MP, MP, MP);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  rows_cols<T, MP, DP / 8>(dv, kcr, sR, ld<T>(DP));        // += kc·rnd(dS)
  band::rows_rows<T, DP, false, MP / 8>(dkp, vr, sR);    // += v·rnd(dS)ᵀ
#pragma unroll
  for (int nb = 0; nb < MP / 8; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) dkp[nb][r] += dz[acc_col(nb, r)];
  store_f32(A.o_dv + (crow + k0 + 16 * w) * d, wrows, d, dv);
  __syncthreads();  // dS and dnum are dead

  // through φ_k (zero stabilizer: no max, no ties): U in 64-feature slices
  stage<T, kSub, DP>(sX, static_cast<const T*>(A.k) + (crow + k0) * d, rows, d);
  cp_commit();
  stage_proj<T, MP>(sR, A.P, A.m, d);
  cp_wait<0>();
  __syncthreads();
  scale_rows<T, Body>(sX, diag, A);
  Rows<T, DP> xr;
  xr.init(sX + 16 * w * ld<T>(DP));
  const float dg[2] = {diag[16 * w + acc_row(0)], diag[16 * w + acc_row(2)]};
  float wsum[2] = {0.f, 0.f};
#pragma unroll
  for (int fs = 0; fs < MP / 64; ++fs) {
    float u[8][4];
    dash<T, 8>(u, xr, sR, 64 * fs);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = 64 * fs + acc_col(nb, r) < A.m;
        const float e = Body == FavorBody::kIdFeat ? u[nb][r] : expf(u[nb][r] - dg[r >> 1]);
        const float de = ok ? dkp[8 * fs + nb][r] * (A.r * e) : 0.f;
        dkp[8 * fs + nb][r] = de;
        wsum[r >> 1] += de;
      }
  }
  wsum[0] = quad_sum(wsum[0]);
  wsum[1] = quad_sum(wsum[1]);
  float dk[DP / 8][4];
  band::zero(dk);
  band::acc_cols<T, DP, MP / 8, DP / 8>(dk, dkp, sR);  // rnd(dE)·rnd(P)
  const T* k = static_cast<const T*>(A.k) + (crow + k0 + 16 * w) * d;
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = acc_row(r), e = acc_col(nb, r);
      if (i < wrows && e < d)
        dk[nb][r] = sub_products(dk[nb][r], A.dn, wsum[r >> 1], A.dn2, to_f(k[(long long)i * d + e]));
    }
  store_f32(A.o_dk + (crow + k0 + 16 * w) * d, wrows, d, dk);
}

// ---------------------------------------------------------------------------
// host launches
// ---------------------------------------------------------------------------

// lets a kernel take more than 48 KB of dynamic shared memory
template <class K>
int allow_smem(K kernel, int smem) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <class K>
int launch(K kernel, int kind, const Args& A, int mp, int elem, int dirs, cudaStream_t s) {
  const int smem = fp::smem_bytes(kind, elem, mp);
  if (int e = allow_smem(kernel, smem)) return e;
  const fp::Grid g = fp::grid(kind, A.bh, A.n, A.chunk, mp, dirs);
  kernel<<<dim3(g.x, g.y, g.z), kThreads, smem, s>>>(A);
  return int(cudaGetLastError());
}

// which: 0 the forward (state, scan, out/den); 1 the backward's state and
// scan, then dq (bit 0 of `parts`) and dk/dv (bit 1)
template <class T, int MP, int Body>
int run(int which, int parts, const Args& A, cudaStream_t s) {
  constexpr int elem = int(sizeof(T));
  constexpr int SB = Body == FavorBody::kIdFeat ? FavorBody::kIdFeat : FavorBody::kFull;
  const int dirs = which ? 2 : 1;
  int e = which ? launch(favor_state_kernel<T, MP, SB, true>, fp::kState, A, MP, elem, 2, s)
                : launch(favor_state_kernel<T, MP, SB, false>, fp::kState, A, MP, elem, 1, s);
  if (e) return e;
  const fp::Grid g = fp::grid(fp::kScan, A.bh, A.n, A.chunk, MP, dirs);
  favor_scan_kernel<T><<<dim3(g.x, g.y, g.z), fp::kScanThreads, 0, s>>>(A, MP);
  if ((e = int(cudaGetLastError()))) return e;
  if (!which) return launch(favor_fwd_kernel<T, MP, Body>, fp::kFwd, A, MP, elem, 1, s);
  if ((parts & 1) && (e = launch(favor_dq_kernel<T, MP, Body>, fp::kDq, A, MP, elem, 1, s)))
    return e;
  if (parts & 2) return launch(favor_dkv_kernel<T, MP, Body>, fp::kDkv, A, MP, elem, 1, s);
  return 0;
}

// the instantiation for m's padded width
template <class T, int Body>
int run_m(int which, int parts, const Args& A, cudaStream_t s) {
  return fp::padded_m(A.m) == 64 ? run<T, 64, Body>(which, parts, A, s)
                                  : run<T, 256, Body>(which, parts, A, s);
}

// Args of a call; the workspace offsets from favor_plan.h
inline Args make_args(int bh, int n, int d, int m, int chunk, int elem, bool bwd, float dn,
                      float half_dn2, float dn2, float r, const void* q, const void* k,
                      const void* v, const void* g, const float* P, const float* out,
                      const float* den, float* o_out, float* o_den, float* o_dq, float* o_dk,
                      float* o_dv, void* work) {
  Args A;
  A.bh = bh;
  A.n = n;
  A.d = d;
  A.m = m;
  A.chunk = chunk;
  A.nc = fp::chunks(n, chunk);
  A.dn = dn;
  A.half_dn2 = half_dn2;
  A.dn2 = dn2;
  A.r = r;
  A.q = q;
  A.k = k;
  A.v = v;
  A.g = g;
  A.P = P;
  A.out = out;
  A.den = den;
  A.o_out = o_out;
  A.o_den = o_den;
  A.o_dq = o_dq;
  A.o_dk = o_dk;
  A.o_dv = o_dv;
  A.work = static_cast<unsigned char*>(work);
  const int mp = fp::padded_m(m);
  for (int a = 0; a < fp::kArrays; ++a) A.off[a] = fp::array_offset(a, bh, n, chunk, mp, elem, bwd);
  return A;
}

}  // namespace fv
