// Block-sparse causal local attention (splash form) for Hopper (sm_90a):
// forward, dq, dk/dv and a fused backward, all deterministic.
//
// Replaces the TPU kernel of synthanatomy_tpu/ops/local_attention_splash.py:
// local_attention_splash (:91), which builds JAX's stock splash-attention
// MHA kernel in _make_kernel (:46) over LocalMask((Lp, Lp), (w-1, 0), 0).
// The plain PyTorch twin is ops/local_attention_splash.py
// (splash_fwd_plain, splash_bwd_plain).
//
// q, k, v (and the cotangent do) are (B·H, Lp, 64) in T (bf16 or f32),
// after rotary, with q already scaled by d^-1/2; Lp is a multiple of the
// 64-row tile.  Key j is visible to query i iff i − w < j ≤ i.  The
// host-built tile map lists, for each query tile, the key tiles with any
// visible pair (and for each key tile the query tiles), each marked full
// or partial: only those tiles are visited, and the mask is applied only
// on partial ones.  Rounding as splash rounds:
//   forward   s = q·kᵀ (f32 sums), masked with −0.7·f32max (finite: a row
//             whose first visited key tile is wholly masked keeps a finite
//             running max, and exp(m_prev − m_next) = 0 wipes what it
//             added once a visible key arrives), an online softmax in f32,
//             P·V with p unrounded, o = acc·(1/l) in T, lse = m + log l;
//   backward  p = exp(s − lse), dp = do·vᵀ, ds = (dp − di)·p with di = Σ
//             o·do (f32, from the wrapper); dq = rnd(ds)·k, dk = rnd(ds)ᵀ·q,
//             dv = rnd(p)ᵀ·do, each summed in f32 and rounded once; the
//             fused form writes dq per (query tile, key tile) in T and a
//             second kernel sums those partials in key-tile order.
// The kernel's 64-row tiles differ from splash's block_q/block_kv (256
// or 128), which set the padding and, in splash and the plain version,
// the order of the online softmax and the width of the fused dq
// partials; the results differ by summation order and, in the fused
// form, by the partials' rounding, which the comparison's tolerance
// covers.  Nothing is added with atomics: two runs give identical bits.
//
// Products.  One warp owns 16 rows of a tile and computes 16 x 8·NB
// products with the mma.sync m16n8k16 accumulator layout.  In bf16 the
// products run on the tensor cores (mma.sync bf16 → f32); every operand
// is already a bf16 value, except p in the forward's P·V, which splash
// keeps in f32: it is split into p = hi + lo (both bf16, |p − hi − lo| ≤
// 2^-17·p) and multiplied in two products.  In f32 the same layout runs
// on FMAs, so the f32 instantiation stays exact f32 (no TF32).
//
// Kernels (128 threads, 4 warps, one block per tile and head):
//   splash_fwd_kernel     per query tile: o and lse;
//   splash_dq_kernel      per query tile: dq (the unfused backward);
//   splash_dkv_kernel     per key tile: dk and dv, and in the fused form
//                         the dq partial of every visited pair;
//   splash_dq_reduce_kernel  sums the dq partials (fused form).
//
// What bounds it on the card.  At the paper shape (B6 x 8 heads, L 1401
// padded to 1536, d 64, w 420) a head visits 180 of 576 tile pairs; the
// forward is ~7 GFLOP of useful work and the backward twice that, against
// ~11 MB of q/k/v/o read per pass, so the bf16 tensor-core rate bounds it
// (~7 µs forward at 989 TFLOP/s), far below what a simple kernel reaches.
// What keeps it from that bound: mma.sync fragments gathered element by
// element from shared memory, a synchronous load of each tile, and the
// extra product for p's low half.  wgmma with TMA-staged tiles is later
// work.

#include <stdint.h>

#include <type_traits>

#include "block_gemm.cuh"

using sa::from_f;
using sa::rnd;
using sa::to_f;

namespace {

constexpr int kTile = 64;  // rows of a query or key tile
constexpr int kD = 64;     // head dim
constexpr int kThreads = 128;
constexpr int kNB = kTile / 8;  // 8-column blocks of a tile-wide product
constexpr int kDB = kD / 8;     // 8-column blocks of a head-wide product
constexpr float kMask = -0.7f * 3.40282346638528859812e+38f;  // splash DEFAULT_MASK_VALUE
constexpr int kPld = kTile + 4;                               // f32 score rows in shared memory

// row stride (elements) of a q/k/v/do tile in shared memory: 16-byte
// aligned rows, offset by 4 banks from the row above
template <class T>
__host__ __device__ constexpr int tile_ld() {
  return kD + (sizeof(T) == 2 ? 8 : 4);
}

template <class T>
__host__ __device__ constexpr int tile_elems() {
  return kTile * tile_ld<T>();
}

struct Map {
  const int* q_ptr;   // nt + 1
  const int* q_ent;   // nnz: key tile << 1 | partial
  const int* k_ptr;   // nt + 1
  const int* k_ent;   // nnz: query tile << 1 | partial
  const int* k_slot;  // nnz: index of the pair in the q-major list
};

__host__ __device__ inline Map make_map(const int* m, int nt, int nnz) {
  Map M;
  M.q_ptr = m;
  M.q_ent = m + nt + 1;
  M.k_ptr = M.q_ent + nnz;
  M.k_ent = M.k_ptr + nt + 1;
  M.k_slot = M.k_ent + nnz;
  return M;
}

struct Args {
  int n, w, nt, bh;
  Map map;
  int* visits;  // optional: tiles visited per block
};

__device__ __forceinline__ bool visible(int i, int j, int w) { return j <= i && j > i - w; }

// 64 rows of kD elements, contiguous in device memory, into shared memory
template <class T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src) {
  constexpr int ld = tile_ld<T>(), vec = 16 / sizeof(T), per_row = kD / vec;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int r = e / per_row, c = (e % per_row) * vec;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(src + r * kD + c);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_part(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[nb] += A (16 x K) · B (K x 8·NB) for one warp.  a(i, k) and b(k, j)
// return f32 operands.  Lane (g = lane / 4, t = lane % 4) holds rows g and
// g + 8, columns 8·nb + 2t and 8·nb + 2t + 1 (acc[nb][0..1] row g,
// acc[nb][2..3] row g + 8), the mma.sync m16n8 accumulator layout, in both
// instantiations; sums run over k in a fixed order.  With SPLIT (bf16
// only) A is taken as f32 and multiplied as hi + lo.
template <class T, int NB, bool SPLIT = false, class FA, class FB>
__device__ __forceinline__ void warp_product(float (&acc)[NB][4], int K, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float a0 = a(g, k), a1 = a(g + 8, k);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float b0 = b(k, nb * 8 + 2 * t), b1 = b(k, nb * 8 + 2 * t + 1);
        acc[nb][0] = fmaf(a0, b0, acc[nb][0]);
        acc[nb][1] = fmaf(a0, b1, acc[nb][1]);
        acc[nb][2] = fmaf(a1, b0, acc[nb][2]);
        acc[nb][3] = fmaf(a1, b1, acc[nb][3]);
      }
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * t, kb = ka + 8;
      const float av[4][2] = {{a(g, ka), a(g, ka + 1)},
                              {a(g + 8, ka), a(g + 8, ka + 1)},
                              {a(g, kb), a(g, kb + 1)},
                              {a(g + 8, kb), a(g + 8, kb + 1)}};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[r] = pack_bf16(av[r][0], av[r][1]);
        if (SPLIT)
          lo[r] = pack_bf16(av[r][0] - bf16_part(av[r][0]), av[r][1] - bf16_part(av[r][1]));
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int j = nb * 8 + g;
        const uint32_t bf[2] = {pack_bf16(b(ka, j), b(ka + 1, j)), pack_bf16(b(kb, j), b(kb + 1, j))};
        mma_bf16(acc[nb], hi, bf);
        if (SPLIT) mma_bf16(acc[nb], lo, bf);
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;
}

// the row (r >> 1) and column (r & 1) offsets of accumulator element r
__device__ __forceinline__ int acc_row(int r) { return (threadIdx.x & 31) / 4 + (r >> 1) * 8; }
__device__ __forceinline__ int acc_col(int nb, int r) {
  return nb * 8 + 2 * ((threadIdx.x & 31) & 3) + (r & 1);
}

// a warp's 16 x kD accumulator, rounded to T, into rows [row0, row0 + 16)
// of a (·, kD) tensor
template <class T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int row0, const float (&acc)[kDB][4],
                                           float scale0, float scale1) {
#pragma unroll
  for (int nb = 0; nb < kDB; ++nb)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      dst[(long long)(row0 + acc_row(r)) * kD + acc_col(nb, r)] =
          from_f<T>(acc[nb][r] * ((r >> 1) ? scale1 : scale0));
}

template <class T>
__host__ __device__ constexpr long long fwd_smem() {
  return 3LL * tile_elems<T>() * sizeof(T) + 4LL * kTile * kPld;
}
template <class T>
__host__ __device__ constexpr long long dq_smem() {
  return 4LL * tile_elems<T>() * sizeof(T) + 4LL * kTile * kPld;
}
template <class T>
__host__ __device__ constexpr long long dkv_smem() {
  return 4LL * tile_elems<T>() * sizeof(T) + 4LL * (2 * kTile * kPld + 2 * kTile);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
splash_fwd_kernel(Args A, const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = tile_ld<T>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + tile_elems<T>();
  T* Vs = Ks + tile_elems<T>();
  float* Ps = reinterpret_cast<float*>(Vs + tile_elems<T>());
  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * kTile;
  const long long base = (long long)bh * A.n * kD;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows
  float* Pw = Ps + r0 * kPld;
  load_tile(Qs, q + base + (long long)q0 * kD);

  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[kDB][4];
  zero(acc);
  int visited = 0;
  for (int e = A.map.q_ptr[qt]; e < A.map.q_ptr[qt + 1]; ++e, ++visited) {
    const int kt = A.map.q_ent[e] >> 1, partial = A.map.q_ent[e] & 1, k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K and V
    load_tile(Ks, k + base + (long long)k0 * kD);
    load_tile(Vs, v + base + (long long)k0 * kD);
    __syncthreads();
    float s[kNB][4];
    zero(s);
    warp_product<T, kNB>(
        s, kD, [&](int i, int c) { return to_f(Qs[(r0 + i) * ld + c]); },
        [&](int c, int j) { return to_f(Ks[j * ld + c]); });
    if (partial) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (!visible(q0 + r0 + acc_row(r), k0 + acc_col(nb, r), A.w)) s[nb][r] = kMask;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      float cur = kMask;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) cur = fmaxf(cur, fmaxf(s[nb][2 * h], s[nb][2 * h + 1]));
      cur = fmaxf(cur, __shfl_xor_sync(0xffffffffu, cur, 1));
      cur = fmaxf(cur, __shfl_xor_sync(0xffffffffu, cur, 2));
      const float m_next = fmaxf(m[h], cur);
      const float alpha = expf(m[h] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[nb][2 * h + c] - m_next);
          s[nb][2 * h + c] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = sum + alpha * l[h];
      m[h] = m_next;
#pragma unroll
      for (int nb = 0; nb < kDB; ++nb) {
        acc[nb][2 * h] *= alpha;
        acc[nb][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) Pw[acc_row(r) * kPld + acc_col(nb, r)] = s[nb][r];
    __syncwarp();
    warp_product<T, kDB, true>(
        acc, kTile, [&](int i, int c) { return Pw[i * kPld + c]; },
        [&](int c, int j) { return to_f(Vs[c * ld + j]); });
  }
  const long long row0 = (long long)bh * A.n + q0 + r0;
  store_rows<T>(o + (long long)bh * A.n * kD, q0 + r0, acc, 1.f / l[0], 1.f / l[1]);
  if ((threadIdx.x & 3) == 0) {
    const int g = (threadIdx.x & 31) >> 2;
    lse[row0 + g] = logf(l[0]) + m[0];
    lse[row0 + g + 8] = logf(l[1]) + m[1];
  }
  if (A.visits && threadIdx.x == 0) A.visits[bh * A.nt + qt] = visited;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
splash_dq_kernel(Args A, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dq) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = tile_ld<T>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + tile_elems<T>();  // do
  T* Ks = Gs + tile_elems<T>();
  T* Vs = Ks + tile_elems<T>();
  float* DSs = reinterpret_cast<float*>(Vs + tile_elems<T>());
  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * kTile;
  const long long base = (long long)bh * A.n * kD;
  const int r0 = (threadIdx.x >> 5) * 16, g = (threadIdx.x & 31) >> 2;
  float* DSw = DSs + r0 * kPld;
  load_tile(Qs, q + base + (long long)q0 * kD);
  load_tile(Gs, dout + base + (long long)q0 * kD);
  const long long row0 = (long long)bh * A.n + q0 + r0;
  const float lse_r[2] = {lse[row0 + g], lse[row0 + g + 8]};
  const float di_r[2] = {di[row0 + g], di[row0 + g + 8]};

  float acc[kDB][4];
  zero(acc);
  int visited = 0;
  for (int e = A.map.q_ptr[qt]; e < A.map.q_ptr[qt + 1]; ++e, ++visited) {
    const int kt = A.map.q_ent[e] >> 1, partial = A.map.q_ent[e] & 1, k0 = kt * kTile;
    __syncthreads();
    load_tile(Ks, k + base + (long long)k0 * kD);
    load_tile(Vs, v + base + (long long)k0 * kD);
    __syncthreads();
    float s[kNB][4], dp[kNB][4];
    zero(s);
    zero(dp);
    warp_product<T, kNB>(
        s, kD, [&](int i, int c) { return to_f(Qs[(r0 + i) * ld + c]); },
        [&](int c, int j) { return to_f(Ks[j * ld + c]); });
    warp_product<T, kNB>(
        dp, kD, [&](int i, int c) { return to_f(Gs[(r0 + i) * ld + c]); },
        [&](int c, int j) { return to_f(Vs[j * ld + c]); });
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[nb][r];
        if (partial && !visible(q0 + r0 + acc_row(r), k0 + acc_col(nb, r), A.w)) x = kMask;
        const float p = expf(x - lse_r[r >> 1]);
        DSw[acc_row(r) * kPld + acc_col(nb, r)] = rnd<T>((dp[nb][r] - di_r[r >> 1]) * p);
      }
    __syncwarp();
    warp_product<T, kDB>(
        acc, kTile, [&](int i, int c) { return DSw[i * kPld + c]; },
        [&](int c, int j) { return to_f(Ks[c * ld + j]); });
  }
  store_rows<T>(dq + base, q0 + r0, acc, 1.f, 1.f);
  if (A.visits && threadIdx.x == 0) A.visits[A.bh * A.nt + bh * A.nt + qt] = visited;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
splash_dkv_kernel(Args A, const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dq_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = tile_ld<T>();
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + tile_elems<T>();
  T* Qs = Vs + tile_elems<T>();
  T* Gs = Qs + tile_elems<T>();  // do
  float* Ps = reinterpret_cast<float*>(Gs + tile_elems<T>());  // rnd(p) of (key, query)
  float* DSs = Ps + kTile * kPld;                               // rnd(ds) of (key, query)
  float* lse_s = DSs + kTile * kPld;
  float* di_s = lse_s + kTile;
  const int kt = blockIdx.x, bh = blockIdx.y, k0 = kt * kTile;
  const long long base = (long long)bh * A.n * kD;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's keys
  float* Pw = Ps + r0 * kPld;
  float* DSw = DSs + r0 * kPld;
  load_tile(Ks, k + base + (long long)k0 * kD);
  load_tile(Vs, v + base + (long long)k0 * kD);

  float dk_acc[kDB][4], dv_acc[kDB][4];
  zero(dk_acc);
  zero(dv_acc);
  int visited = 0;
  for (int e = A.map.k_ptr[kt]; e < A.map.k_ptr[kt + 1]; ++e, ++visited) {
    const int qt = A.map.k_ent[e] >> 1, partial = A.map.k_ent[e] & 1, q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous Q, do and dS
    load_tile(Qs, q + base + (long long)q0 * kD);
    load_tile(Gs, dout + base + (long long)q0 * kD);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lse_s[i] = lse[(long long)bh * A.n + q0 + i];
      di_s[i] = di[(long long)bh * A.n + q0 + i];
    }
    __syncthreads();
    float pt[kNB][4], dpt[kNB][4];  // (key, query)
    zero(pt);
    zero(dpt);
    warp_product<T, kNB>(
        pt, kD, [&](int i, int c) { return to_f(Ks[(r0 + i) * ld + c]); },
        [&](int c, int j) { return to_f(Qs[j * ld + c]); });
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = acc_col(nb, r);
        float x = pt[nb][r];
        if (partial && !visible(q0 + qi, k0 + r0 + acc_row(r), A.w)) x = kMask;
        pt[nb][r] = expf(x - lse_s[qi]);
        Pw[acc_row(r) * kPld + qi] = rnd<T>(pt[nb][r]);
      }
    __syncwarp();
    warp_product<T, kDB>(
        dv_acc, kTile, [&](int i, int c) { return Pw[i * kPld + c]; },
        [&](int c, int j) { return to_f(Gs[c * ld + j]); });
    warp_product<T, kNB>(
        dpt, kD, [&](int i, int c) { return to_f(Vs[(r0 + i) * ld + c]); },
        [&](int c, int j) { return to_f(Gs[j * ld + c]); });
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = acc_col(nb, r);
        DSw[acc_row(r) * kPld + qi] = rnd<T>((dpt[nb][r] - di_s[qi]) * pt[nb][r]);
      }
    __syncwarp();
    warp_product<T, kDB>(
        dk_acc, kTile, [&](int i, int c) { return DSw[i * kPld + c]; },
        [&](int c, int j) { return to_f(Qs[c * ld + j]); });
    if (dq_part) {
      // this pair's dq partial, rnd(ds)·k over the tile's 64 keys: every
      // warp's dS rows are needed, each warp takes 16 queries
      __syncthreads();
      float pq[kDB][4];
      zero(pq);
      warp_product<T, kDB>(
          pq, kTile, [&](int i, int c) { return DSs[c * kPld + r0 + i]; },
          [&](int c, int j) { return to_f(Ks[c * ld + j]); });
      const long long slot = A.map.k_slot[e];
      store_rows<T>(dq_part + (slot * A.bh + bh) * kTile * kD, r0, pq, 1.f, 1.f);
    }
  }
  store_rows<T>(dk + base, k0 + r0, dk_acc, 1.f, 1.f);
  store_rows<T>(dv + base, k0 + r0, dv_acc, 1.f, 1.f);
  if (A.visits && threadIdx.x == 0) A.visits[bh * A.nt + kt] = visited;
}

// dq of one query tile: its pairs' partials summed in f32 in key-tile
// order, rounded once
template <class T>
__global__ void __launch_bounds__(kThreads)
splash_dq_reduce_kernel(Args A, const T* __restrict__ dq_part, T* __restrict__ dq) {
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int s0 = A.map.q_ptr[qt], s1 = A.map.q_ptr[qt + 1];
  T* out = dq + ((long long)bh * A.n + (long long)qt * kTile) * kD;
  for (int x = threadIdx.x; x < kTile * kD; x += kThreads) {
    float acc = 0.f;
    for (int s = s0; s < s1; ++s) acc += to_f(dq_part[((long long)s * A.bh + bh) * kTile * kD + x]);
    out[x] = from_f<T>(acc);
  }
}

template <class K>
int allow_smem(K kernel, long long bytes) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)));
}

template <class T>
int fwd(const Args& A, const void* q, const void* k, const void* v, void* o, float* lse,
        cudaStream_t s) {
  auto kern = splash_fwd_kernel<T>;
  if (int e = allow_smem(kern, fwd_smem<T>())) return e;
  kern<<<dim3(A.nt, A.bh), kThreads, fwd_smem<T>(), s>>>(
      A, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse);
  return int(cudaGetLastError());
}

template <class T>
int bwd(const Args& A, bool fused, const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* di, void* dq, void* dk, void* dv, void* dq_part,
        cudaStream_t s) {
  const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k),
          *v_ = static_cast<const T*>(v), *g_ = static_cast<const T*>(dout);
  const dim3 grid(A.nt, A.bh);
  if (!fused) {
    auto kdq = splash_dq_kernel<T>;
    if (int e = allow_smem(kdq, dq_smem<T>())) return e;
    kdq<<<grid, kThreads, dq_smem<T>(), s>>>(A, q_, k_, v_, g_, lse, di, static_cast<T*>(dq));
    if (int e = int(cudaGetLastError())) return e;
  }
  auto kkv = splash_dkv_kernel<T>;
  if (int e = allow_smem(kkv, dkv_smem<T>())) return e;
  kkv<<<grid, kThreads, dkv_smem<T>(), s>>>(A, q_, k_, v_, g_, lse, di, static_cast<T*>(dk),
                                            static_cast<T*>(dv),
                                            fused ? static_cast<T*>(dq_part) : nullptr);
  if (int e = int(cudaGetLastError())) return e;
  if (fused) {
    splash_dq_reduce_kernel<T><<<grid, kThreads, 0, s>>>(A, static_cast<const T*>(dq_part),
                                                         static_cast<T*>(dq));
    return int(cudaGetLastError());
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  map: the tile map (ops/local_attention_splash.py
// _device_map) of nt tiles and nnz visited pairs.  visits (optional, B·H x
// nt ints) receives the tiles each block visited.  Returns a cudaError_t.
int splash_fwd(int bh, int n, int w, int dtype, const int* map, int nt, int nnz, const void* q,
               const void* k, const void* v, void* o, float* lse, int* visits, void* stream) {
  const Args A{n, w, nt, bh, make_map(map, nt, nnz), visits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd<__nv_bfloat16>(A, q, k, v, o, lse, s) : fwd<float>(A, q, k, v, o, lse, s);
}

// Two launches: dq then dk/dv, or with `fused` dk/dv with the dq partials
// (nnz x B·H x 64 x 64 in T, in dq_part) then their reduction.  visits
// (optional, 2 x B·H x nt ints): the dk/dv kernel's, then the dq kernel's.
int splash_bwd(int bh, int n, int w, int dtype, const int* map, int nt, int nnz, int fused,
               const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, void* dq, void* dk, void* dv, void* dq_part, int* visits,
               void* stream) {
  const Args A{n, w, nt, bh, make_map(map, nt, nnz), visits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bwd<__nv_bfloat16>(A, fused != 0, q, k, v, dout, lse, di, dq, dk, dv,
                                         dq_part, s)
                    : bwd<float>(A, fused != 0, q, k, v, dout, lse, di, dq, dk, dv, dq_part, s);
}

}  // extern "C"
