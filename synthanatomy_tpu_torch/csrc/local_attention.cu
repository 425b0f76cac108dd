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
// the shares in f32; here a key tile sums its shares in f32 and rounds
// once, and nothing is added with atomics, so two runs give identical
// gradients.
//
// The tile form (d ≤ 128), on the shared tile core (band_attention.cuh):
// 64-row tiles, one warpgroup a block, products on the tensor cores in
// bf16 (FMAs in f32), tiles staged by cp.async into a ring of 2 or 3
// slots.  The
// row max is over the whole band before any e is rounded, so the forward
// and the dq kernel walk their key tiles twice: a first pass for the row
// statistics (max, and where a body needs them Σe and Σ dP·e, rescaled
// online in f32 — only sums of f32 values are rescaled, never a rounded
// e), then the products.  Two passes bound no window.
//   local_fwd_kernel     per (64 queries, head): pass 1 S = Q·Kᵀ for the
//                        max, pass 2 S again, e, Σe and rnd(e)·V;
//   local_bwd_dq_kernel  per (64 queries, head): pass 1 S and dP for m, Σe
//                        and t = Σ dP·P (written to the row statistics, f32,
//                        B·H x L), pass 2 dS = P·(dP − t) and rnd(dS)·K;
//   local_bwd_dkv_kernel per (64 keys, head): walks the query tiles that see
//                        them, rebuilding P and dS from the statistics: dv
//                        += rnd(P)ᵀ·g, dk += rnd(dS)ᵀ·Q, rounded once.
// Each takes `hpb`, the (batch·head) rows a block walks in turn (grid.y =
// ceil(B·H / hpb)), and a body: the production launches take the
// FwdBody::kFoldScale and BwdBody::kFull bodies with hpb 1, the
// kernel-body probe (ops/kernel_body.py) every body and hpb at d ≤ 64 (its
// ablations are built at DP 64 alone); it replaces the Pallas bodies of
// tools/probe_kernel_body.py (local_fwd_variant :93, local_bwd_variant
// :168).  The head dim is zero-padded to DP = 64 or 128 in the staged
// tiles; the padding adds zeros to every product.  The tile geometry, the
// walk and the shared memory of the launches are in band_plan.h.
//
// The band form (d > 128, where a tile's accumulators outgrow the
// registers): the earlier kernels, unchanged — 32 queries a block with the
// 32 x (32 + w − 1) f32 score band in shared memory and f32 FMA products
// (block_gemm.cuh); w is bounded by the band's shared memory.
//   band_fwd_kernel, band_bwd_dq_kernel, band_bwd_dkv_kernel.
//
// What bounds it on the card: the band is w·d multiply-adds per query and
// product (~0.12 GFLOP per head per product at the paper shape, L 1400,
// w 420, d 64), so operations: 14·pairs·d FLOP for forward and backward
// (~21.5 GFLOP at B6 x 8 heads), 0.022 ms at the bf16 tensor-core peak.
// The tile form runs 3 products a visited tile pair forward and 9 backward
// (the bound counts 2 and 5), over ~148 visited pairs a head where the band
// fills ~123.  With mma.sync every warp loads its own B fragments from
// shared memory, so the shared-memory reads, the tensor pipe and the
// softmax's FP32 and SFU work share the instruction slots of 8 warps an SM (the
// registers allow 2 blocks); the softmax therefore runs on ex2 in log2
// units, and a full tile pair's loops carry no mask.  wgmma (B read once
// per warpgroup), TMA and a producer warp are the next step; PERF.md §6
// has the times.

#include <stdint.h>

#include "band_attention.cuh"

using sa::from_f;
using sa::rnd;
using sa::to_f;

namespace {

using band::kThreads;
using band::kTile;
using band::kNT;

struct Band {
  int n, d, w;
  float scale;  // d^-1/2
  int vec;      // d·sizeof(T) and every input 16-byte aligned: cp.async staging
};

// Bodies of the kernel-body probe (ops/kernel_body.py), compile-time
// ablations; the production launches take FwdBody::kFoldScale and
// BwdBody::kFull.
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

// ---------------------------------------------------------------------------
// the tile form
// ---------------------------------------------------------------------------

// The softmax keeps its scores in log2 units (s·log2 e), so each e is one
// subtraction and one ex2 on the SFU (ex2.approx: within a few f32 ulps of
// expf for the band's arguments, far inside one bf16 rounding of the P and
// dS it feeds); the row max is written back in natural units.
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// 2^(x − m), 0 where m is still −inf (nothing visible yet)
__device__ __forceinline__ float ex2_from(float x, float m) {
  return m == -INFINITY ? 0.f : band::ex2(x - m);
}

// the ring's slots and the launches' shared memory: band_plan.h
template <class T, int DP>
__host__ __device__ constexpr int slots() {
  return band::ring_slots(int(sizeof(T)), DP);
}
template <class T, int DP>
constexpr int fwd_smem() {
  return band::fwd_smem(int(sizeof(T)), DP);
}
template <class T, int DP>
constexpr int dq_smem() {
  return band::dq_smem(int(sizeof(T)), DP);
}
template <class T, int DP>
constexpr int dkv_smem() {
  return band::dkv_smem(int(sizeof(T)), DP);
}

// One block's forward: 64 queries of tile qt of the (batch·head) row bh.
template <class T, int DP, int Body>
__device__ __forceinline__ void tile_fwd_body(const Band& B, long long bh, int qt,
                                              const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, T* __restrict__ out,
                                              unsigned char* smem) {
  constexpr bool kFold = Body == FwdBody::kFoldScale;
  constexpr bool kSoftmax = Body != FwdBody::kMatmuls;
  constexpr bool kMax = kSoftmax && Body != FwdBody::kNoMax;
  constexpr bool kNormFirst = Body == FwdBody::kFull || Body == FwdBody::kNoMax;
  constexpr int ld = band::tile_ld<T, DP>(), TE = band::tile_elems<T, DP>(), NB = DP / 8;
  constexpr int S = slots<T, DP>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + TE;      // S slots
  T* Vs = Ks + S * TE;  // S slots
  const int n = B.n, d = B.d, w = B.w, q0 = qt * kTile, rows = min(kTile, n - q0);
  const int r0 = 16 * (threadIdx.x >> 5);
  const long long base = bh * n * d;
  const int kt0 = band::first_key_tile(qt, w), nk = qt - kt0 + 1;
  const int steps = kSoftmax ? 2 * nk : nk;  // a statistics pass, then the products
  band::TileRows<T, DP, true> qa;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NB][4];
  band::zero(o);
  band::stage_tile<T, DP>(Qs, q + base + (long long)q0 * d, rows, d, B.vec);
  band::ring_walk<S>(
      steps,
      [&](int s, int slot) {
        const bool second = kSoftmax && s >= nk;
        const int k0 = (kt0 + (second ? s - nk : s)) * kTile, kr = min(kTile, n - k0);
        band::stage_tile<T, DP>(Ks + slot * TE, k + base + (long long)k0 * d, kr, d, B.vec);
        if (second || !kSoftmax)
          band::stage_tile<T, DP>(Vs + slot * TE, v + base + (long long)k0 * d, kr, d, B.vec);
      },
      [&]() {
        if constexpr (kFold) {  // q·d^-1/2 rounded to T, as the TPU kernel's operand
          for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
            T& x = Qs[(e / DP) * ld + e % DP];
            x = from_f<T>(to_f(x) * B.scale);
          }
          __syncthreads();
        }
        qa.init(Qs + r0 * ld);
      },
      [&](int s, int slot) {
        const bool second = kSoftmax && s >= nk;
        const int kt = kt0 + (second ? s - nk : s), k0 = kt * kTile;
        // i − j of this lane's element (0, 0); element (nb, r) adds 8·(r >> 1) − 8·nb − (r & 1)
        const int dij = q0 + r0 - k0 + band::acc_row(0) - band::acc_col(0, 0);
        float sc[kNT][4];
        band::zero(sc);
        band::rows_rows(sc, qa, Ks + slot * TE);
        band::by_mask(band::tile_full(qt, kt, n, w), [&](auto masked) {
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              // in log2 units for the softmax, natural for kMatmuls' P
              const float x = sc[nb][r] * ((kFold ? 1.f : B.scale) * (kSoftmax ? kLog2e : 1.f));
              const bool in = !decltype(masked)::value ||
                              band::in_band(dij + 8 * (r >> 1) - 8 * nb - (r & 1), w);
              sc[nb][r] = in ? x : (kSoftmax ? -INFINITY : 0.f);
            }
        });
        if (kSoftmax && !second) {  // pass 1: this lane's max (and Σe) of rows g, g + 8
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (kMax) {
              float cur = m[h];
#pragma unroll
              for (int nb = 0; nb < kNT; ++nb) cur = fmaxf(cur, fmaxf(sc[nb][2 * h], sc[nb][2 * h + 1]));
              if constexpr (kNormFirst) {
                float sum = 0.f;
#pragma unroll
                for (int nb = 0; nb < kNT; ++nb)
                  sum += ex2_from(sc[nb][2 * h], cur) + ex2_from(sc[nb][2 * h + 1], cur);
                l[h] = l[h] * ex2_from(m[h], cur) + sum;
              }
              m[h] = cur;
            } else {  // kNoMax
#pragma unroll
              for (int nb = 0; nb < kNT; ++nb) l[h] += band::ex2(sc[nb][2 * h]) + band::ex2(sc[nb][2 * h + 1]);
            }
          }
          return;
        }
        if (second && s == nk) {  // the rows' statistics, over the lanes that share them
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (kMax) {
              const float mx = band::quad_max(m[h]);
              if constexpr (kNormFirst) l[h] = band::quad_sum(l[h] * ex2_from(m[h], mx));
              m[h] = mx;
            } else {
              l[h] = band::quad_sum(l[h]);
            }
          }
        }
        if constexpr (kSoftmax) {
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int h = r >> 1;
              const float e = band::ex2(kMax ? sc[nb][r] - m[h] : sc[nb][r]);
              if constexpr (kNormFirst) {
                sc[nb][r] = e / l[h];
              } else {
                sc[nb][r] = e;
                l[h] += e;
              }
            }
        }
        band::acc_cols<T, DP>(o, sc, Vs + slot * TE);
      });
  if constexpr (kSoftmax && !kNormFirst) {
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = band::quad_sum(l[h]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[nb][r] = o[nb][r] / l[r >> 1];
  }
  band::store_rows<T>(out + base + (long long)(q0 + r0) * d, rows - r0, d, o, 1.f, 1.f);
}

// One block's dq (and, with the softmax, the row statistics): 64 queries
// of tile qt of row bh; gradients written in O.
template <class T, class O, int DP, int Body>
__device__ __forceinline__ void tile_dq_body(const Band& B, long long bh, int qt,
                                             const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, const T* __restrict__ g,
                                             O* __restrict__ dq, float* __restrict__ rmax,
                                             float* __restrict__ rsum, float* __restrict__ rdot,
                                             unsigned char* smem) {
  constexpr bool kSoftmax = Body == BwdBody::kFull;
  constexpr bool kKeep = DP <= 64;  // Q and g fragments held in registers
  constexpr int ld = band::tile_ld<T, DP>(), TE = band::tile_elems<T, DP>(), NB = DP / 8;
  constexpr int S = slots<T, DP>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + TE;
  T* Ks = Gs + TE;      // S slots
  T* Vs = Ks + S * TE;  // S slots
  const int n = B.n, d = B.d, w = B.w, q0 = qt * kTile, rows = min(kTile, n - q0);
  const int r0 = 16 * (threadIdx.x >> 5);
  const long long base = bh * n * d;
  const int kt0 = band::first_key_tile(qt, w), nk = qt - kt0 + 1;
  const int steps = kSoftmax ? 2 * nk : nk;
  band::TileRows<T, DP, kKeep> qa, ga;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f}, rl[2];
  float acc[NB][4];
  band::zero(acc);
  band::stage_tile<T, DP>(Qs, q + base + (long long)q0 * d, rows, d, B.vec);
  band::stage_tile<T, DP>(Gs, g + base + (long long)q0 * d, rows, d, B.vec);
  band::ring_walk<S>(
      steps,
      [&](int s, int slot) {
        const int k0 = (kt0 + (s >= nk ? s - nk : s)) * kTile, kr = min(kTile, n - k0);
        band::stage_tile<T, DP>(Ks + slot * TE, k + base + (long long)k0 * d, kr, d, B.vec);
        band::stage_tile<T, DP>(Vs + slot * TE, v + base + (long long)k0 * d, kr, d, B.vec);
      },
      [&]() {
        qa.init(Qs + r0 * ld);
        ga.init(Gs + r0 * ld);
      },
      [&](int s, int slot) {
        const bool second = kSoftmax && s >= nk;
        const int kt = kt0 + (second ? s - nk : s), k0 = kt * kTile;
        const int dij = q0 + r0 - k0 + band::acc_row(0) - band::acc_col(0, 0);  // as the forward's
        float sc[kNT][4], dp[kNT][4];
        band::zero(sc);
        band::zero(dp);
        band::rows_rows(sc, qa, Ks + slot * TE);
        band::rows_rows(dp, ga, Vs + slot * TE);
        if (kSoftmax && s == nk) {  // m, Σe and t = Σ dP·P of the rows, written once
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float mx = band::quad_max(m[h]), f = ex2_from(m[h], mx);
            l[h] = band::quad_sum(l[h] * f);
            t[h] = band::quad_sum(t[h] * f) / l[h];
            rl[h] = 1.f / l[h];
            m[h] = mx;
          }
          const int i = q0 + r0 + (threadIdx.x & 31) / 4;
          if ((threadIdx.x & 3) == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (i + 8 * h < n) {
                rmax[bh * n + i + 8 * h] = m[h] * kLn2;
                rsum[bh * n + i + 8 * h] = l[h];
                rdot[bh * n + i + 8 * h] = t[h];
              }
          }
        }
        band::by_mask(band::tile_full(qt, kt, n, w), [&](auto masked) {
          auto in = [&](int nb, int r) {
            return !decltype(masked)::value ||
                   band::in_band(dij + 8 * (r >> 1) - 8 * nb - (r & 1), w);
          };
          if constexpr (kSoftmax) {
#pragma unroll
            for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
              for (int r = 0; r < 4; ++r) sc[nb][r] *= B.scale * kLog2e;
            if (!second) {  // pass 1: this lane's max, Σe and Σ dP·e of rows g, g + 8
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float cur = m[h];
#pragma unroll
                for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
                  for (int c = 0; c < 2; ++c)
                    if (in(nb, 2 * h + c)) cur = fmaxf(cur, sc[nb][2 * h + c]);
                float se = 0.f, sde = 0.f;
#pragma unroll
                for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
                  for (int c = 0; c < 2; ++c) {
                    const float e = in(nb, 2 * h + c) ? band::ex2(sc[nb][2 * h + c] - cur) : 0.f;
                    se += e;
                    sde += dp[nb][2 * h + c] * e;
                  }
                const float alpha = ex2_from(m[h], cur);
                l[h] = l[h] * alpha + se;
                t[h] = t[h] * alpha + sde;
                m[h] = cur;
              }
              return;
            }
#pragma unroll
            for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int h = r >> 1;
                const float p = in(nb, r) ? band::ex2(sc[nb][r] - m[h]) * rl[h] : 0.f;
                dp[nb][r] = p * (dp[nb][r] - t[h]);
              }
          } else {
#pragma unroll
            for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
              for (int r = 0; r < 4; ++r) dp[nb][r] = in(nb, r) ? dp[nb][r] : 0.f;
          }
        });
        if (kSoftmax && !second) return;
        band::acc_cols<T, DP>(acc, dp, Ks + slot * TE);  // dq += rnd(dS)·K
      });
  band::store_rows<O>(dq + base + (long long)(q0 + r0) * d, rows - r0, d, acc, B.scale, B.scale);
}

// One block's dk/dv: 64 keys of tile kt of row bh, in O.
template <class T, class O, int DP, int Body>
__device__ __forceinline__ void tile_dkv_body(const Band& B, long long bh, int kt,
                                              const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, const T* __restrict__ g,
                                              const float* __restrict__ rmax,
                                              const float* __restrict__ rsum,
                                              const float* __restrict__ rdot, O* __restrict__ dk,
                                              O* __restrict__ dv, unsigned char* smem) {
  constexpr bool kSoftmax = Body == BwdBody::kFull;
  constexpr bool kKeep = DP <= 64;  // K and V fragments held in registers
  constexpr int ld = band::tile_ld<T, DP>(), TE = band::tile_elems<T, DP>(), NB = DP / 8;
  constexpr int S = slots<T, DP>();
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + TE;
  T* Qs = Vs + TE;      // S slots
  T* Gs = Qs + S * TE;  // S slots
  float* St = reinterpret_cast<float*>(Gs + S * TE);  // S slots of max, Σe, t
  const int n = B.n, d = B.d, w = B.w, k0 = kt * kTile, kr = min(kTile, n - k0);
  const int r0 = 16 * (threadIdx.x >> 5);
  const long long base = bh * n * d;
  const int steps = band::last_query_tile(kt, n, w) - kt + 1;
  band::TileRows<T, DP, kKeep> ka, va;
  float dka[NB][4], dva[NB][4];
  band::zero(dka);
  band::zero(dva);
  band::stage_tile<T, DP>(Ks, k + base + (long long)k0 * d, kr, d, B.vec);
  band::stage_tile<T, DP>(Vs, v + base + (long long)k0 * d, kr, d, B.vec);
  band::ring_walk<S>(
      steps,
      [&](int s, int slot) {
        const int q0 = (kt + s) * kTile, qr = min(kTile, n - q0);
        band::stage_tile<T, DP>(Qs + slot * TE, q + base + (long long)q0 * d, qr, d, B.vec);
        band::stage_tile<T, DP>(Gs + slot * TE, g + base + (long long)q0 * d, qr, d, B.vec);
        if constexpr (kSoftmax) {
          float* st = St + slot * 3 * kTile;
          band::stage_row(st, rmax + bh * n + q0, qr);
          band::stage_row(st + kTile, rsum + bh * n + q0, qr);
          band::stage_row(st + 2 * kTile, rdot + bh * n + q0, qr);
        }
      },
      [&]() {
        ka.init(Ks + r0 * ld);
        va.init(Vs + r0 * ld);
      },
      [&](int s, int slot) {
        const int qt = kt + s, q0 = qt * kTile;
        const bool full = band::tile_full(qt, kt, n, w);
        const float* st = St + slot * 3 * kTile;
        // query i = q0 + column, key j = k0 + r0 + row: i − j of this lane's
        // element (0, 0); element (nb, r) adds 8·nb + (r & 1) − 8·(r >> 1)
        const int c0 = band::acc_col(0, 0);
        const int dij = q0 + c0 - k0 - r0 - band::acc_row(0), qn = n - q0 - c0;
        auto in = [&](int nb, int r) {
          return band::in_band(dij + 8 * nb + (r & 1) - 8 * (r >> 1), w) && 8 * nb + (r & 1) < qn;
        };
        float m2[kNT][2], rl[kNT][2], tq[kNT][2];  // this lane's query columns
        if constexpr (kSoftmax) {
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = c0 + 8 * nb + c;
              m2[nb][c] = st[i] * kLog2e;
              rl[nb][c] = 1.f / st[kTile + i];
              tq[nb][c] = st[2 * kTile + i];
            }
        }
        float pt[kNT][4], dpt[kNT][4];  // (key, query)
        band::zero(pt);
        band::zero(dpt);
        band::rows_rows(pt, ka, Qs + slot * TE);
        band::by_mask(full, [&](auto masked) {
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const bool vis = !decltype(masked)::value || in(nb, r);
              if constexpr (kSoftmax)
                pt[nb][r] = vis ? band::ex2(pt[nb][r] * (B.scale * kLog2e) - m2[nb][r & 1]) *
                                      rl[nb][r & 1]
                                : 0.f;
              else pt[nb][r] = vis ? pt[nb][r] * B.scale : 0.f;
            }
        });
        band::acc_cols<T, DP>(dva, pt, Gs + slot * TE);  // dv += rnd(P)ᵀ·g
        band::rows_rows(dpt, va, Gs + slot * TE);          // dPᵀ = V·gᵀ
        if constexpr (kSoftmax) {  // P is 0 outside the band
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int r = 0; r < 4; ++r) dpt[nb][r] = pt[nb][r] * (dpt[nb][r] - tq[nb][r & 1]);
        } else {
          band::by_mask(full, [&](auto masked) {
#pragma unroll
            for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                dpt[nb][r] = (!decltype(masked)::value || in(nb, r)) ? dpt[nb][r] : 0.f;
          });
        }
        band::acc_cols<T, DP>(dka, dpt, Qs + slot * TE);  // dk += rnd(dS)ᵀ·Q
      });
  const long long row0 = base + (long long)(k0 + r0) * d;
  band::store_rows<O>(dk + row0, kr - r0, d, dka, B.scale, B.scale);
  band::store_rows<O>(dv + row0, kr - r0, d, dva, 1.f, 1.f);
}

template <class T, int DP, int Body>
__global__ void __launch_bounds__(kThreads)
local_fwd_kernel(Band B, int bh, int hpb, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r1 = min(bh, int(blockIdx.y + 1) * hpb);
  for (int r = blockIdx.y * hpb; r < r1; ++r) {
    __syncthreads();
    tile_fwd_body<T, DP, Body>(B, r, blockIdx.x, q, k, v, out, smem);
  }
}

template <class T, class O, int DP, int Body>
__global__ void __launch_bounds__(kThreads)
local_bwd_dq_kernel(Band B, int bh, int hpb, const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g, O* __restrict__ dq,
                    float* __restrict__ rmax, float* __restrict__ rsum,
                    float* __restrict__ rdot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r1 = min(bh, int(blockIdx.y + 1) * hpb);
  for (int r = blockIdx.y * hpb; r < r1; ++r) {
    __syncthreads();
    tile_dq_body<T, O, DP, Body>(B, r, blockIdx.x, q, k, v, g, dq, rmax, rsum, rdot, smem);
  }
}

template <class T, class O, int DP, int Body>
__global__ void __launch_bounds__(kThreads)
local_bwd_dkv_kernel(Band B, int bh, int hpb, const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ rmax, const float* __restrict__ rsum,
                     const float* __restrict__ rdot, O* __restrict__ dk, O* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r1 = min(bh, int(blockIdx.y + 1) * hpb);
  for (int r = blockIdx.y * hpb; r < r1; ++r) {
    __syncthreads();
    tile_dkv_body<T, O, DP, Body>(B, r, blockIdx.x, q, k, v, g, rmax, rsum, rdot, dk, dv, smem);
  }
}

// ---------------------------------------------------------------------------
// the band form (d > 128): the earlier FMA kernels
// ---------------------------------------------------------------------------

using G = sa::Gemm<32, 64>;
static_assert(G::kThreads == kThreads, "one block shape for both forms");
static_assert(G::kSmemFloats == band::kGemmFloats, "band_plan.h counts the staging tiles");
using band::band_ld;
using band::band_stage;
using band::dkv_stage;
using band::kKT;
using band::kQS;
using band::kQT;

__device__ __forceinline__ bool allowed(const Band& B, int i, int j) {
  return j <= i && j > i - B.w && j >= 0;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
band_fwd_kernel(Band B, const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out) {
  extern __shared__ float fsmem[];
  const int n = B.n, d = B.d, ld = band_ld(B.w), q0 = blockIdx.x * kQT;
  float* SC = fsmem;             // kQT x ld
  float* lsum = SC + kQT * ld;   // kQT
  float* stage = fsmem + band_stage(B.w, 1);
  const int rows = min(kQT, n - q0);
  const int ks = max(0, q0 - B.w + 1), span = q0 + rows - ks;
  const long long bh = blockIdx.y;
  q += bh * n * d;
  k += bh * n * d;
  v += bh * n * d;
  out += bh * n * d;
  const float scale = B.scale;
  G::run<true, true>(
      rows, span, d, [&](int i, int e) { return rnd<T>(to_f(q[(q0 + i) * d + e]) * scale); },
      [&](int e, int j) { return to_f(k[(ks + j) * d + e]); },
      [&](int i, int j, float acc) {
        SC[i * ld + j] = allowed(B, q0 + i, ks + j) ? acc : -INFINITY;
      },
      stage);
  for (int i = threadIdx.x >> 5; i < rows; i += kThreads / 32) {
    const int lane = threadIdx.x & 31;
    float mx = -INFINITY, s = 0.f;
    for (int j = lane; j < span; j += 32) mx = fmaxf(mx, SC[i * ld + j]);
    mx = sa::warp_max(mx);
    for (int j = lane; j < span; j += 32) {
      const float e = expf(SC[i * ld + j] - mx);
      SC[i * ld + j] = e;
      s += e;
    }
    s = sa::warp_sum(s);
    if (lane == 0) lsum[i] = s;
  }
  __syncthreads();
  G::run<true, false>(
      rows, d, span, [&](int i, int j) { return rnd<T>(SC[i * ld + j]); },
      [&](int j, int e) { return to_f(v[(ks + j) * d + e]); },
      [&](int i, int e, float acc) { out[(q0 + i) * d + e] = from_f<T>(acc / lsum[i]); }, stage);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
band_bwd_dq_kernel(Band B, const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
                   float* __restrict__ rmax, float* __restrict__ rsum,
                   float* __restrict__ rdot) {
  extern __shared__ float fsmem[];
  const int n = B.n, d = B.d, ld = band_ld(B.w), q0 = blockIdx.x * kQT;
  float* P = fsmem;              // kQT x ld: scores, then probabilities
  float* DS = P + kQT * ld;      // kQT x ld: dP, then dS
  float* stage = fsmem + band_stage(B.w, 2);
  const int rows = min(kQT, n - q0);
  const int ks = max(0, q0 - B.w + 1), span = q0 + rows - ks;
  const long long bh = blockIdx.y;
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
        P[i * ld + j] = allowed(B, q0 + i, ks + j) ? acc * scale : -INFINITY;
      },
      stage);
  for (int i = threadIdx.x >> 5; i < rows; i += kThreads / 32) {
    const int lane = threadIdx.x & 31;
    float mx = -INFINITY, s = 0.f;
    for (int j = lane; j < span; j += 32) mx = fmaxf(mx, P[i * ld + j]);
    mx = sa::warp_max(mx);
    for (int j = lane; j < span; j += 32) {
      const float e = expf(P[i * ld + j] - mx);
      P[i * ld + j] = e;
      s += e;
    }
    s = sa::warp_sum(s);
    for (int j = lane; j < span; j += 32) P[i * ld + j] = P[i * ld + j] / s;
    if (lane == 0) {
      rmax[q0 + i] = mx;
      rsum[q0 + i] = s;
    }
  }
  G::run<true, true>(
      rows, span, d, [&](int i, int e) { return to_f(g[(q0 + i) * d + e]); },
      [&](int e, int j) { return to_f(v[(ks + j) * d + e]); },
      [&](int i, int j, float acc) { DS[i * ld + j] = acc; }, stage);
  for (int i = threadIdx.x >> 5; i < rows; i += kThreads / 32) {
    const int lane = threadIdx.x & 31;
    float t = 0.f;
    for (int j = lane; j < span; j += 32) t += DS[i * ld + j] * P[i * ld + j];
    t = sa::warp_sum(t);
    for (int j = lane; j < span; j += 32) DS[i * ld + j] = P[i * ld + j] * (DS[i * ld + j] - t);
    if (lane == 0) rdot[q0 + i] = t;
  }
  __syncthreads();
  G::run<true, false>(
      rows, d, span, [&](int i, int j) { return rnd<T>(DS[i * ld + j]); },
      [&](int j, int e) { return to_f(k[(ks + j) * d + e]); },
      [&](int i, int e, float acc) { dq[(q0 + i) * d + e] = from_f<T>(acc * scale); }, stage);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
band_bwd_dkv_kernel(Band B, const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ rmax, const float* __restrict__ rsum,
                    const float* __restrict__ rdot, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float fsmem[];
  const int n = B.n, d = B.d, k0 = blockIdx.x * kKT;
  float* PT = fsmem;              // kKT x kQS: P of (key, query)
  float* DST = PT + kKT * kQS;    // kKT x kQS: dS of (key, query)
  float* DK = DST + kKT * kQS;    // kKT x d
  float* DV = DK + kKT * d;       // kKT x d
  float* stage = fsmem + dkv_stage(d);
  const int kr = min(kKT, n - k0);
  const int qe = min(n, k0 + kr - 1 + B.w);  // queries [k0, qe) see some key of the block
  const long long bh = blockIdx.y;
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
    G::run<true, true>(
        kr, nq, d, [&](int j, int e) { return to_f(k[(k0 + j) * d + e]); },
        [&](int e, int i) { return to_f(q[(i0 + i) * d + e]); },
        [&](int j, int i, float acc) {
          const int qi = i0 + i;
          PT[j * kQS + i] =
              allowed(B, qi, k0 + j) ? expf(acc * scale - rmax[qi]) / rsum[qi] : 0.f;
        },
        stage);
    G::run<true, true>(
        kr, nq, d, [&](int j, int e) { return to_f(v[(k0 + j) * d + e]); },
        [&](int e, int i) { return to_f(g[(i0 + i) * d + e]); },
        [&](int j, int i, float acc) {
          DST[j * kQS + i] = PT[j * kQS + i] * (acc - rdot[i0 + i]);
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
    dk[k0 * d + x] = from_f<T>(DK[x] * scale);
    dv[k0 * d + x] = from_f<T>(DV[x]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

using band::kTileMaxD;

template <class K>
int allow_smem(K kernel, long long smem) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem)));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class T>
Band make_band(int n, int d, int w, float scale, const void* q, const void* k, const void* v,
               const void* g) {
  const bool vec = (d * sizeof(T)) % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   (g == nullptr || aligned16(g));
  return Band{n, d, w, scale, int(vec)};
}

template <class T, int DP, int Body>
int fwd_tiles(const Band& B, int bh, int hpb, const void* q, const void* k, const void* v,
              void* out, cudaStream_t s) {
  auto kern = local_fwd_kernel<T, DP, Body>;
  if (int e = allow_smem(kern, fwd_smem<T, DP>())) return e;
  kern<<<dim3(band::tiles(B.n), (bh + hpb - 1) / hpb), kThreads, fwd_smem<T, DP>(), s>>>(
      B, bh, hpb, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out));
  return int(cudaGetLastError());
}

template <class T, class O, int DP, int Body>
int bwd_tiles(const Band& B, int bh, int hpb, const void* q, const void* k, const void* v,
              const void* g, void* dq, void* dk, void* dv, float* rmax, float* rsum, float* rdot,
              cudaStream_t s) {
  const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k),
          *v_ = static_cast<const T*>(v), *g_ = static_cast<const T*>(g);
  const dim3 grid(band::tiles(B.n), (bh + hpb - 1) / hpb);
  auto kdq = local_bwd_dq_kernel<T, O, DP, Body>;
  if (int e = allow_smem(kdq, dq_smem<T, DP>())) return e;
  kdq<<<grid, kThreads, dq_smem<T, DP>(), s>>>(B, bh, hpb, q_, k_, v_, g_, static_cast<O*>(dq),
                                               rmax, rsum, rdot);
  if (int e = int(cudaGetLastError())) return e;
  auto kkv = local_bwd_dkv_kernel<T, O, DP, Body>;
  if (int e = allow_smem(kkv, dkv_smem<T, DP>())) return e;
  kkv<<<grid, kThreads, dkv_smem<T, DP>(), s>>>(B, bh, hpb, q_, k_, v_, g_, rmax, rsum, rdot,
                                                static_cast<O*>(dk), static_cast<O*>(dv));
  return int(cudaGetLastError());
}

template <class T, int Body>
int fwd_any(int bh, int hpb, int n, int d, int w, float scale, const void* q, const void* k,
            const void* v, void* out, cudaStream_t s) {
  const Band B = make_band<T>(n, d, w, scale, q, k, v, nullptr);
  if (d <= 64) return fwd_tiles<T, 64, Body>(B, bh, hpb, q, k, v, out, s);
  // the probe's ablations are built at DP 64 only (every configuration's d)
  if constexpr (Body != FwdBody::kFoldScale) {
    return int(cudaErrorInvalidValue);
  } else {
    if (d <= kTileMaxD) return fwd_tiles<T, kTileMaxD, Body>(B, bh, hpb, q, k, v, out, s);
    if (hpb != 1) return int(cudaErrorInvalidValue);
    auto kern = band_fwd_kernel<T>;
    const long long smem = band::band_smem(d, w);
    if (int e = allow_smem(kern, smem)) return e;
    kern<<<dim3((n + kQT - 1) / kQT, bh), kThreads, smem, s>>>(
        B, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out));
    return int(cudaGetLastError());
  }
}

template <class T, class O, int Body>
int bwd_any(int bh, int hpb, int n, int d, int w, float scale, const void* q, const void* k,
            const void* v, const void* g, void* dq, void* dk, void* dv, float* rmax, float* rsum,
            float* rdot, cudaStream_t s) {
  const Band B = make_band<T>(n, d, w, scale, q, k, v, g);
  if (d <= 64)
    return bwd_tiles<T, O, 64, Body>(B, bh, hpb, q, k, v, g, dq, dk, dv, rmax, rsum, rdot, s);
  // the probe's ablations (and f32 outputs of bf16) are built at DP 64 only
  if constexpr (!std::is_same<T, O>::value || Body != BwdBody::kFull) {
    return int(cudaErrorInvalidValue);
  } else {
    if (d <= kTileMaxD)
      return bwd_tiles<T, O, kTileMaxD, Body>(B, bh, hpb, q, k, v, g, dq, dk, dv, rmax, rsum,
                                              rdot, s);
    if (hpb != 1) return int(cudaErrorInvalidValue);
    const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k),
            *v_ = static_cast<const T*>(v), *g_ = static_cast<const T*>(g);
    const long long smem = band::band_smem(d, w);
    auto kdq = band_bwd_dq_kernel<T>;
    if (int e = allow_smem(kdq, smem)) return e;
    kdq<<<dim3((n + kQT - 1) / kQT, bh), kThreads, smem, s>>>(B, q_, k_, v_, g_,
                                                              static_cast<T*>(dq), rmax, rsum,
                                                              rdot);
    if (int e = int(cudaGetLastError())) return e;
    auto kkv = band_bwd_dkv_kernel<T>;
    if (int e = allow_smem(kkv, smem)) return e;
    kkv<<<dim3((n + kKT - 1) / kKT, bh), kThreads, smem, s>>>(
        B, q_, k_, v_, g_, rmax, rsum, rdot, static_cast<T*>(dk), static_cast<T*>(dv));
    return int(cudaGetLastError());
  }
}

template <class T>
int fwd_body(int body, int bh, int hpb, int n, int d, int w, float scale, const void* q,
             const void* k, const void* v, void* out, cudaStream_t s) {
  switch (body) {
    case FwdBody::kFoldScale:
      return fwd_any<T, FwdBody::kFoldScale>(bh, hpb, n, d, w, scale, q, k, v, out, s);
    case FwdBody::kFull:
      return fwd_any<T, FwdBody::kFull>(bh, hpb, n, d, w, scale, q, k, v, out, s);
    case FwdBody::kDefer:
      return fwd_any<T, FwdBody::kDefer>(bh, hpb, n, d, w, scale, q, k, v, out, s);
    case FwdBody::kNoMax:
      return fwd_any<T, FwdBody::kNoMax>(bh, hpb, n, d, w, scale, q, k, v, out, s);
    case FwdBody::kMatmuls:
      return fwd_any<T, FwdBody::kMatmuls>(bh, hpb, n, d, w, scale, q, k, v, out, s);
  }
  return int(cudaErrorInvalidValue);
}

template <class T, class O>
int bwd_body(int body, int bh, int hpb, int n, int d, int w, float scale, const void* q,
             const void* k, const void* v, const void* g, void* dq, void* dk, void* dv,
             float* rmax, float* rsum, float* rdot, cudaStream_t s) {
  switch (body) {
    case BwdBody::kFull:
      return bwd_any<T, O, BwdBody::kFull>(bh, hpb, n, d, w, scale, q, k, v, g, dq, dk, dv,
                                           rmax, rsum, rdot, s);
    case BwdBody::kMatmuls:
      return bwd_any<T, O, BwdBody::kMatmuls>(bh, hpb, n, d, w, scale, q, k, v, g, dq, dk, dv,
                                              rmax, rsum, rdot, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of the largest of the three kernels that
// local_fwd/local_bwd launch for head dim d, window w and dtype (0 = f32,
// 1 = bf16): band_plan.h.
long long local_smem_bytes(int d, int w, int dtype) {
  return band::local_smem_bytes(d, w, dtype == 1 ? 2 : 4);
}

// dtype: 0 = f32, 1 = bf16.  Returns a cudaError_t.
int local_fwd(int bh, int n, int d, int w, int dtype, float scale, const void* q,
              const void* k, const void* v, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? fwd_any<__nv_bfloat16, FwdBody::kFoldScale>(bh, 1, n, d, w, scale, q, k, v, out, s)
             : fwd_any<float, FwdBody::kFoldScale>(bh, 1, n, d, w, scale, q, k, v, out, s);
}

// Two launches: dq (and the row statistics), then dk/dv.
int local_bwd(int bh, int n, int d, int w, int dtype, float scale, const void* q,
              const void* k, const void* v, const void* g, void* dq, void* dk, void* dv,
              float* rmax, float* rsum, float* rdot, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? bwd_any<__nv_bfloat16, __nv_bfloat16, BwdBody::kFull>(
                   bh, 1, n, d, w, scale, q, k, v, g, dq, dk, dv, rmax, rsum, rdot, s)
             : bwd_any<float, float, BwdBody::kFull>(bh, 1, n, d, w, scale, q, k, v, g, dq, dk,
                                                     dv, rmax, rsum, rdot, s);
}

// The kernel-body probe (ops/kernel_body.py), tile form at DP 64 only (d ≤ 64).
// body: 0-4 = foldscale (the production forward's body), full, defer,
// nomax, matmuls; hpb: (batch·head) rows one block walks.
int local_fwd_probe(int body, int hpb, int bh, int n, int d, int w, int dtype, float scale,
                    const void* q, const void* k, const void* v, void* out, void* stream) {
  if (d > 64 || hpb < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd_body<__nv_bfloat16>(body, bh, hpb, n, d, w, scale, q, k, v, out, s)
                    : fwd_body<float>(body, bh, hpb, n, d, w, scale, q, k, v, out, s);
}

// body: 0 = full (the production backward's body), 1 = matmuls; out_f32:
// dq, dk and dv written in f32 (else in the compute dtype).
int local_bwd_probe(int body, int hpb, int out_f32, int bh, int n, int d, int w, int dtype,
                    float scale, const void* q, const void* k, const void* v, const void* g,
                    void* dq, void* dk, void* dv, float* rmax, float* rsum, float* rdot,
                    void* stream) {
  if (d > 64 || hpb < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1)
    return bwd_body<float, float>(body, bh, hpb, n, d, w, scale, q, k, v, g, dq, dk, dv, rmax,
                                  rsum, rdot, s);
  return out_f32 ? bwd_body<__nv_bfloat16, float>(body, bh, hpb, n, d, w, scale, q, k, v, g, dq,
                                                  dk, dv, rmax, rsum, rdot, s)
                 : bwd_body<__nv_bfloat16, __nv_bfloat16>(body, bh, hpb, n, d, w, scale, q, k,
                                                          v, g, dq, dk, dv, rmax, rsum, rdot, s);
}

}  // extern "C"
