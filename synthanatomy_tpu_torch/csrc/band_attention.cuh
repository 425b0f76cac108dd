// The shared Hopper tile core of the port's two causal local-attention
// kernels: row 6 (local_attention.cu, the banded flash kernel) and row 8
// (local_attention_splash.cu, splash).  Both compute attention of query i
// over keys i − w < j ≤ i, each at its own rounding points; this header
// holds what they share: tiles, staging, the products and the walk.
//
// Tiles and warps.  Query and key tiles are 64 rows.  A block is one
// warpgroup (4 warps, 128 threads) and owns one 64-row tile of its own
// (queries in a forward or dq kernel, keys in a dk/dv kernel); warp w owns
// rows 16w … 16w + 15 of it.  Every product is a warp's 16 rows by 8·NB
// columns in the mma.sync m16n8k16 accumulator layout: lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 8·nb + 2t and 8·nb + 2t + 1
// of column block nb (acc[nb][0..1] row g, acc[nb][2..3] row g + 8).
//
// Products.  In bf16 they run on the tensor cores, bf16 x bf16 summed in
// f32 (mma.sync m16n8k16), with every fragment loaded by ldmatrix: plain
// for an operand whose contraction runs along a staged row (S = Q·Kᵀ,
// dP = g·Vᵀ and their transposes), .trans for one whose contraction runs
// down the staged rows (P·V, dS·K, Pᵀ·g, dSᵀ·Q).  A computed operand (P,
// dS) goes from the accumulators to the A fragments in registers, rounded
// to bf16 on the way, which is where the TPU kernels round it.  In f32 the
// same layout runs on FMAs (operands read from shared memory, a computed A
// operand taken by shuffle from the lane that holds it), so f32 stays
// exact f32 (no TF32).  Sums run over k in a fixed order: no atomics, and
// two runs give identical bits.
//
// Shared memory.  A staged tile holds DP columns (the head dim, zero-padded
// to DP) in rows padded by 16 bytes: the row stride is 4 banks mod 32, so
// the 8 rows an ldmatrix phase reads fall on distinct banks.  Tiles are
// copied by cp.async, 16 bytes a thread, zero-filled past the tensor's rows
// and columns, into a ring of slots (ring_walk): the copies of the next
// tiles are in flight while the current one is multiplied.
//
// The walk of row 6 (row 8 takes the same tiles from its host-built map).
// A query tile visits the key tiles from ⌊(q0 − w + 1)/64⌋ to its own; a
// key tile visits the query tiles from its own to the last that sees one
// of its keys.  Only a partial tile pair (the diagonal, and the one or two
// that the window's lower edge crosses) is masked.  The walk, the tile
// geometry and row 6's shared memory are in band_plan.h (plain C++), which
// the CPU tests compile and hold to the dense band.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "band_plan.h"
#include "block_gemm.cuh"
#include "mma_frag.cuh"

namespace band {

using sa::from_f;

constexpr int kWarps = 4;  // one warpgroup: 16 rows of the block's tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = kTile / 8;  // 8-column blocks of a tile-wide product

template <class T>
constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// ---------------------------------------------------------------------------
// tile geometry and masks (the walk is in band_plan.h)
// ---------------------------------------------------------------------------

// row stride (elements) of a staged tile of DP columns (band_plan.h)
template <class T, int DP>
__host__ __device__ constexpr int tile_ld() {
  return row_ld(int(sizeof(T)), DP);
}

template <class T, int DP>
__host__ __device__ constexpr int tile_elems() {
  return kTile * tile_ld<T, DP>();
}

__device__ __forceinline__ bool visible(int i, int j, int w) { return j <= i && j > i - w; }

// the same from the offset i − j: 0 ≤ i − j < w
__device__ __forceinline__ bool in_band(int i_minus_j, int w) { return unsigned(i_minus_j) < unsigned(w); }

// f(std::true_type) on a tile pair that needs the mask, f(std::false_type)
// on a full one, so that a full pair's element loops carry no mask
template <class F>
__device__ __forceinline__ void by_mask(bool full, F f) {
  if (full) f(std::false_type{});
  else f(std::true_type{});
}

// ---------------------------------------------------------------------------
// asynchronous staging
// ---------------------------------------------------------------------------

using frag::cp_async16;
using frag::cp_async4;
using frag::cp_commit;
using frag::cp_wait;
using frag::smem_addr;

// Rows [0, rows) x columns [0, d) of a row-major (·, d) tensor, from src
// (its first row), into a staged tile; the rest of the tile's 64 x DP is
// zero.  vec (d·sizeof(T) and src 16-byte aligned): cp.async of 16 bytes,
// committed by the caller; else plain loads and stores.
template <class T, int DP>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int rows, int d,
                                           bool vec) {
  constexpr int ld = tile_ld<T, DP>();
  if (vec) {
    constexpr int per = 16 / int(sizeof(T)), chunks = DP / per;
    for (int e = threadIdx.x; e < kTile * chunks; e += kThreads) {
      const int r = e / chunks, c = (e % chunks) * per;
      const bool ok = r < rows && c < d;
      cp_async16(dst + r * ld + c, ok ? src + (long long)r * d + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      dst[r * ld + c] = (r < rows && c < d) ? src[(long long)r * d + c] : from_f<T>(0.f);
    }
  }
}

// 64 floats of a row statistic (zeros past `rows`)
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ src, int rows) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) cp_async4(dst + i, i < rows ? src + i : src, i < rows);
}

// A ring of Slots slots over `steps` tiles.  stage(s, slot) starts the
// copies of step s into ring slot `slot`; compute(s, slot) runs its
// products.  The copies of the next Slots − 1 steps are in flight while a
// step computes (one commit group a step, empty past the end, so the
// count of groups still pending is fixed).  The caller starts the copies
// of its own tiles first: they land with step 0's, before ready() (which
// may rewrite shared memory, ending with a barrier, and loads fragments
// that stay in registers).  One barrier a step publishes the step's tiles
// and frees the slot that the step's own copies refill.
template <int Slots = 2, class Stage, class Ready, class Compute>
__device__ __forceinline__ void ring_walk(int steps, Stage stage, Ready ready, Compute compute) {
  static_assert(Slots >= 2 && Slots <= 4, "ring of 2 to 4 slots");
#pragma unroll
  for (int i = 0; i < Slots - 1; ++i) {
    if (i < steps) stage(i, i);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_wait<Slots - 2>();  // step s's group (and every earlier one) has landed
    __syncthreads();
    if (s == 0) ready();
    if (s + Slots - 1 < steps) stage(s + Slots - 1, (s + Slots - 1) % Slots);
    cp_commit();
    compute(s, s % Slots);
  }
}

// ---------------------------------------------------------------------------
// fragments and products
// ---------------------------------------------------------------------------

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }

// the row (of the warp's 16) and column of accumulator element r of block nb
__device__ __forceinline__ int acc_row(int r) { return (lane() >> 2) + 8 * (r >> 1); }
__device__ __forceinline__ int acc_col(int nb, int r) { return 8 * nb + 2 * (lane() & 3) + (r & 1); }

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;
}

// 2^x on the SFU (ex2.approx: within a few f32 ulps; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// e^x as 2^(x·log2 e) on the SFU; an argument of −0.7·f32max (splash's
// finite mask) goes to −inf there and gives 0, as expf does
__device__ __forceinline__ float exp_sfu(float x) { return ex2(x * 1.4426950408889634f); }

// over the 4 lanes that hold one row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

using frag::ldsm4;
using frag::ldsm4_t;
using frag::mma;
using frag::pack;

// what is left of x after its bf16 rounding
__device__ __forceinline__ float lo_part(float x) { return x - __bfloat162float(__float2bfloat16(x)); }

// A warp's 16 rows of a staged tile as the A operand of products over its
// DP columns: in bf16 the fragments are held in registers (Keep) or loaded
// by ldmatrix at each use; in f32 the rows are read from shared memory.
template <class T, int DP, bool Keep>
struct TileRows {
  static constexpr bool kHeld = Keep && kTensorCores<T>;
  const T* p;  // the warp's first row
  uint32_t f[kHeld ? DP / 16 : 1][4];

  __device__ __forceinline__ void init(const T* rows) {
    p = rows;
    if constexpr (kHeld) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) load(ks, f[ks]);
    }
  }

  __device__ __forceinline__ void load(int ks, uint32_t (&a)[4]) const {
    // matrix l / 8 of x4: rows + 8·(its bit 0), columns + 8·(its bit 1)
    ldsm4(a, p + (lane() & 15) * tile_ld<T, DP>() + 16 * ks + (lane() >> 4) * 8);
  }

  __device__ __forceinline__ void frag(int ks, uint32_t (&a)[4]) const {
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[ks][i];
    } else {
      load(ks, a);
    }
  }
};

// acc (16 x 8·NB) += A (16 x DP) · Bᵀ, where B's rows (from `b`, a staged
// tile's first row) are the output columns: S = Q·Kᵀ and dP = g·Vᵀ, and
// in dk/dv their transposes.
template <class T, int DP, bool Keep, int NB>
__device__ __forceinline__ void rows_rows(float (&acc)[NB][4], const TileRows<T, DP, Keep>& a,
                                          const T* b) {
  constexpr int ld = tile_ld<T, DP>();
  const int l = lane();
  if constexpr (kTensorCores<T>) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      uint32_t af[4];
      a.frag(ks, af);
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        // matrices: (cols 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
        uint32_t bf[4];
        ldsm4(bf, b + (16 * p + (l & 7) + (l >> 4) * 8) * ld + 16 * ks + ((l >> 3) & 1) * 8);
        mma(acc[2 * p], af, bf[0], bf[1]);
        mma(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    const int g = l >> 2, t = l & 3;
#pragma unroll 4
    for (int k = 0; k < DP; ++k) {
      const float a0 = a.p[g * ld + k], a1 = a.p[(g + 8) * ld + k];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float b0 = b[(8 * nb + 2 * t) * ld + k], b1 = b[(8 * nb + 2 * t + 1) * ld + k];
        acc[nb][0] = fmaf(a0, b0, acc[nb][0]);
        acc[nb][1] = fmaf(a0, b1, acc[nb][1]);
        acc[nb][2] = fmaf(a1, b0, acc[nb][2]);
        acc[nb][3] = fmaf(a1, b1, acc[nb][3]);
      }
    }
  }
}

// acc (16 x 8·NB) += rnd(P) · B: P (16 x 8·KB) in the accumulator layout,
// B (8·KB x 8·NB) the first 8·KB rows of a staged tile from `b`, read down
// its rows (P·V, dS·K, Pᵀ·g, dSᵀ·Q).  In bf16 P is rounded to bf16 as it
// enters the fragments; SPLIT multiplies it as hi + lo, two bf16 parts
// (|p − hi − lo| ≤ 2^-17·|p|), where P is not to be rounded.
template <class T, int DP, int KB, int NB, bool SPLIT = false>
__device__ __forceinline__ void acc_cols(float (&acc)[NB][4], const float (&P)[KB][4],
                                         const T* b) {
  constexpr int ld = tile_ld<T, DP>();
  const int l = lane();
  if constexpr (kTensorCores<T>) {
#pragma unroll
    for (int kc = 0; kc < KB / 2; ++kc) {
      // A of m16n8k16 from two accumulator blocks: (row g, k 0-7), (g + 8,
      // 0-7), (g, 8-15), (g + 8, 8-15)
      const uint32_t af[4] = {pack(P[2 * kc][0], P[2 * kc][1]), pack(P[2 * kc][2], P[2 * kc][3]),
                              pack(P[2 * kc + 1][0], P[2 * kc + 1][1]),
                              pack(P[2 * kc + 1][2], P[2 * kc + 1][3])};
      uint32_t lo[4];
      if constexpr (SPLIT) {
        lo[0] = pack(lo_part(P[2 * kc][0]), lo_part(P[2 * kc][1]));
        lo[1] = pack(lo_part(P[2 * kc][2]), lo_part(P[2 * kc][3]));
        lo[2] = pack(lo_part(P[2 * kc + 1][0]), lo_part(P[2 * kc + 1][1]));
        lo[3] = pack(lo_part(P[2 * kc + 1][2]), lo_part(P[2 * kc + 1][3]));
      }
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        // .trans matrices: (k 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        uint32_t bf[4];
        ldsm4_t(bf, b + (16 * kc + (l & 7) + ((l >> 3) & 1) * 8) * ld + 16 * p + (l >> 4) * 8);
        mma(acc[2 * p], af, bf[0], bf[1]);
        mma(acc[2 * p + 1], af, bf[2], bf[3]);
        if constexpr (SPLIT) {
          mma(acc[2 * p], lo, bf[0], bf[1]);
          mma(acc[2 * p + 1], lo, bf[2], bf[3]);
        }
      }
    }
  } else {
    const int t = l & 3;
#pragma unroll
    for (int k = 0; k < 8 * KB; ++k) {
      // P[g][k] and P[g + 8][k] live in lane 4g + (k % 8) / 2
      const int src = (l & ~3) | ((k & 7) >> 1);
      const float a0 = __shfl_sync(0xffffffffu, P[k >> 3][k & 1], src);
      const float a1 = __shfl_sync(0xffffffffu, P[k >> 3][2 + (k & 1)], src);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float b0 = b[k * ld + 8 * nb + 2 * t], b1 = b[k * ld + 8 * nb + 2 * t + 1];
        acc[nb][0] = fmaf(a0, b0, acc[nb][0]);
        acc[nb][1] = fmaf(a0, b1, acc[nb][1]);
        acc[nb][2] = fmaf(a1, b0, acc[nb][2]);
        acc[nb][3] = fmaf(a1, b1, acc[nb][3]);
      }
    }
  }
}

// acc (16 x 8·NB) += Sᵀ · B over k < 64: S a staged [k][m] tile (S[k][m] at
// s + k·lds + m, m from the warp's m0), B as in acc_cols.  Splash's fused
// dq partial, whose dS was computed with keys as rows.
template <class T, int DP, int NB>
__device__ __forceinline__ void cols_cols(float (&acc)[NB][4], const T* s, int lds, int m0,
                                          const T* b) {
  constexpr int ld = tile_ld<T, DP>();
  const int l = lane();
  if constexpr (kTensorCores<T>) {
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      // .trans matrices: (m 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
      uint32_t af[4];
      ldsm4_t(af, s + (16 * kc + (l & 7) + (l >> 4) * 8) * lds + m0 + ((l >> 3) & 1) * 8);
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        uint32_t bf[4];
        ldsm4_t(bf, b + (16 * kc + (l & 7) + ((l >> 3) & 1) * 8) * ld + 16 * p + (l >> 4) * 8);
        mma(acc[2 * p], af, bf[0], bf[1]);
        mma(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
  } else {
    const int g = l >> 2, t = l & 3;
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      const float a0 = s[k * lds + m0 + g], a1 = s[k * lds + m0 + g + 8];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float b0 = b[k * ld + 8 * nb + 2 * t], b1 = b[k * ld + 8 * nb + 2 * t + 1];
        acc[nb][0] = fmaf(a0, b0, acc[nb][0]);
        acc[nb][1] = fmaf(a0, b1, acc[nb][1]);
        acc[nb][2] = fmaf(a1, b0, acc[nb][2]);
        acc[nb][3] = fmaf(a1, b1, acc[nb][3]);
      }
    }
  }
}

// A warp's 16 x 8·NB accumulator, times s0 (row g) or s1 (row g + 8), in O,
// into rows [0, rows) and columns [0, d) of a row-major (·, d) tensor from
// dst (the warp's first row)
template <class O, int NB>
__device__ __forceinline__ void store_rows(O* __restrict__ dst, int rows, int d,
                                           const float (&acc)[NB][4], float s0, float s1) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = acc_row(r), c = acc_col(nb, r);
      if (i < rows && c < d) dst[(long long)i * d + c] = from_f<O>(acc[nb][r] * ((r >> 1) ? s1 : s0));
    }
}

}  // namespace band
