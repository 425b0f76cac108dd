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
// The tile core (band_attention.cuh), shared with row 6.  A block is one
// warpgroup on one 64-row tile; each warp owns 16 of its rows.  In bf16
// every product runs on the tensor cores (mma.sync m16n8k16, bf16 → f32
// sums) with fragments loaded by ldmatrix, and a computed operand (p, ds)
// passes from the accumulators to the A fragments in registers.  Every
// operand is a bf16 value already, except p in the forward's P·V, which
// splash keeps in f32: it is split into p = hi + lo (both bf16, |p − hi −
// lo| ≤ 2^-17·p) and multiplied in two products.  In f32 the same layout
// runs on FMAs, so the f32 instantiation stays exact f32 (no TF32).  The
// visited K/V (or Q/do) tiles stream through a 2-slot cp.async ring: the
// next tile of the map is copied while the current one is multiplied.
//
// Kernels (128 threads, one block per tile and head):
//   splash_fwd_kernel     per query tile: o and lse;
//   splash_dq_kernel      per query tile: dq (the unfused backward);
//   splash_dkv_kernel     per key tile: dk and dv, and in the fused form
//                         the dq partial of every visited pair (its rnd(ds)
//                         tile staged in shared memory, read transposed);
//   splash_dq_reduce_kernel  sums the dq partials (fused form).
//
// What bounds it on the card.  At the paper shape (B6 x 8 heads, L 1401
// padded to 1536, d 64, w 420) a head visits 164 of 576 tile pairs; the
// forward is ~7 GFLOP of useful work and the backward twice that, against
// ~11 MB of q/k/v/o read per pass, so the bf16 tensor-core rate bounds it
// (~7 µs forward at 989 TFLOP/s).  What keeps it from that bound: every
// warp loads its own B fragments from shared memory (mma.sync), the
// forward's second product for p's low half, and the f32 softmax (exp on
// the SFU, masks on the partial tiles) on the same warps; wgmma with
// TMA-staged tiles and a producer warp is later work (PERF.md §6 has the
// times).

#include <stdint.h>

#include "band_attention.cuh"

using sa::from_f;
using sa::rnd;
using sa::to_f;

namespace {

using band::kThreads;
using band::kTile;
using band::kNT;
constexpr int kD = 64;          // head dim
constexpr int kDB = kD / 8;     // 8-column blocks of a head-wide product
constexpr float kMask = -0.7f * 3.40282346638528859812e+38f;  // splash DEFAULT_MASK_VALUE

template <class T>
using Rows = band::TileRows<T, kD, true>;

template <class T>
__host__ __device__ constexpr int tile_elems() {
  return band::tile_elems<T, kD>();
}

// the fused form's rnd(ds) tile, (key, query), rows padded by 16 bytes
template <class T>
__host__ __device__ constexpr int ds_ld() {
  return kTile + 16 / int(sizeof(T));
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

// shared memory (bytes): forward Q + 2 x (K, V); dq Q, do + 2 x (K, V);
// dk/dv K, V + 2 x (Q, do, lse, di) + the rnd(ds) tile
template <class T>
__host__ __device__ constexpr long long fwd_smem() {
  return 5LL * tile_elems<T>() * sizeof(T);
}
template <class T>
__host__ __device__ constexpr long long dq_smem() {
  return 6LL * tile_elems<T>() * sizeof(T);
}
template <class T>
__host__ __device__ constexpr long long dkv_smem() {
  return 6LL * tile_elems<T>() * sizeof(T) + 2LL * 2 * kTile * sizeof(float) +
         1LL * kTile * ds_ld<T>() * sizeof(T);
}

// a 64 x kD tile of a (·, kD) tensor from row `row`: every row is real
template <class T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, long long row) {
  band::stage_tile<T, kD>(dst, src + row * kD, kTile, kD, true);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
splash_fwd_kernel(Args A, const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TE = tile_elems<T>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + TE;      // 2 slots
  T* Vs = Ks + 2 * TE;  // 2 slots
  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * kTile;
  const long long base = (long long)bh * A.n * kD;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's rows
  const int e0 = A.map.q_ptr[qt], steps = A.map.q_ptr[qt + 1] - e0;
  Rows<T> qa;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[kDB][4];
  band::zero(acc);
  int visited = 0;
  stage(Qs, q + base, q0);
  band::ring_walk(
      steps,
      [&](int s, int slot) {
        const long long k0 = (long long)(A.map.q_ent[e0 + s] >> 1) * kTile;
        stage(Ks + slot * TE, k + base, k0);
        stage(Vs + slot * TE, v + base, k0);
      },
      [&]() { qa.init(Qs + r0 * band::tile_ld<T, kD>()); },
      [&](int s, int slot) {
        const int ent = A.map.q_ent[e0 + s], k0 = (ent >> 1) * kTile;
        ++visited;
        float sc[kNT][4];
        band::zero(sc);
        band::rows_rows(sc, qa, Ks + slot * TE);
        if (ent & 1) {  // partial
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if (!band::visible(q0 + r0 + band::acc_row(r), k0 + band::acc_col(nb, r), A.w))
                sc[nb][r] = kMask;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          float cur = kMask;
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb) cur = fmaxf(cur, fmaxf(sc[nb][2 * h], sc[nb][2 * h + 1]));
          const float m_next = fmaxf(m[h], band::quad_max(cur));
          const float alpha = band::exp_sfu(m[h] - m_next);
          float sum = 0.f;
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float p = band::exp_sfu(sc[nb][2 * h + c] - m_next);
              sc[nb][2 * h + c] = p;
              sum += p;
            }
          l[h] = band::quad_sum(sum) + alpha * l[h];
          m[h] = m_next;
#pragma unroll
          for (int nb = 0; nb < kDB; ++nb) {
            acc[nb][2 * h] *= alpha;
            acc[nb][2 * h + 1] *= alpha;
          }
        }
        band::acc_cols<T, kD, kNT, kDB, true>(acc, sc, Vs + slot * TE);  // p unrounded
      });
  const long long row0 = (long long)bh * A.n + q0 + r0;
  band::store_rows<T>(o + base + (long long)(q0 + r0) * kD, 16, kD, acc, 1.f / l[0], 1.f / l[1]);
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
  constexpr int TE = tile_elems<T>(), ld = band::tile_ld<T, kD>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + TE;      // do
  T* Ks = Gs + TE;      // 2 slots
  T* Vs = Ks + 2 * TE;  // 2 slots
  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * kTile;
  const long long base = (long long)bh * A.n * kD;
  const int r0 = 16 * (threadIdx.x >> 5), g = (threadIdx.x & 31) >> 2;
  const int e0 = A.map.q_ptr[qt], steps = A.map.q_ptr[qt + 1] - e0;
  const long long row0 = (long long)bh * A.n + q0 + r0;
  const float lse_r[2] = {lse[row0 + g], lse[row0 + g + 8]};
  const float di_r[2] = {di[row0 + g], di[row0 + g + 8]};
  Rows<T> qa, ga;
  float acc[kDB][4];
  band::zero(acc);
  int visited = 0;
  stage(Qs, q + base, q0);
  stage(Gs, dout + base, q0);
  band::ring_walk(
      steps,
      [&](int s, int slot) {
        const long long k0 = (long long)(A.map.q_ent[e0 + s] >> 1) * kTile;
        stage(Ks + slot * TE, k + base, k0);
        stage(Vs + slot * TE, v + base, k0);
      },
      [&]() {
        qa.init(Qs + r0 * ld);
        ga.init(Gs + r0 * ld);
      },
      [&](int s, int slot) {
        const int ent = A.map.q_ent[e0 + s], k0 = (ent >> 1) * kTile;
        ++visited;
        float sc[kNT][4], dp[kNT][4];
        band::zero(sc);
        band::zero(dp);
        band::rows_rows(sc, qa, Ks + slot * TE);
        band::rows_rows(dp, ga, Vs + slot * TE);
#pragma unroll
        for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float x = sc[nb][r];
            if ((ent & 1) &&
                !band::visible(q0 + r0 + band::acc_row(r), k0 + band::acc_col(nb, r), A.w))
              x = kMask;
            const float p = band::exp_sfu(x - lse_r[r >> 1]);
            dp[nb][r] = (dp[nb][r] - di_r[r >> 1]) * p;
          }
        band::acc_cols<T, kD>(acc, dp, Ks + slot * TE);  // dq += rnd(ds)·k
      });
  band::store_rows<T>(dq + base + (long long)(q0 + r0) * kD, 16, kD, acc, 1.f, 1.f);
  if (A.visits && threadIdx.x == 0) A.visits[A.bh * A.nt + bh * A.nt + qt] = visited;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
splash_dkv_kernel(Args A, const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dq_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TE = tile_elems<T>(), ld = band::tile_ld<T, kD>(), dld = ds_ld<T>();
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + TE;
  T* Qs = Vs + TE;      // 2 slots
  T* Gs = Qs + 2 * TE;  // 2 slots of do
  float* Ls = reinterpret_cast<float*>(Gs + 2 * TE);  // 2 slots of lse, di
  T* DSs = reinterpret_cast<T*>(Ls + 2 * 2 * kTile);  // rnd(ds) of (key, query)
  const int kt = blockIdx.x, bh = blockIdx.y, k0 = kt * kTile;
  const long long base = (long long)bh * A.n * kD;
  const int r0 = 16 * (threadIdx.x >> 5);  // the warp's keys
  const int e0 = A.map.k_ptr[kt], steps = A.map.k_ptr[kt + 1] - e0;
  Rows<T> ka, va;
  float dk_acc[kDB][4], dv_acc[kDB][4];
  band::zero(dk_acc);
  band::zero(dv_acc);
  int visited = 0;
  stage(Ks, k + base, k0);
  stage(Vs, v + base, k0);
  band::ring_walk(
      steps,
      [&](int s, int slot) {
        const int q0 = (A.map.k_ent[e0 + s] >> 1) * kTile;
        stage(Qs + slot * TE, q + base, q0);
        stage(Gs + slot * TE, dout + base, q0);
        band::stage_row(Ls + slot * 2 * kTile, lse + (long long)bh * A.n + q0, kTile);
        band::stage_row(Ls + slot * 2 * kTile + kTile, di + (long long)bh * A.n + q0, kTile);
      },
      [&]() {
        ka.init(Ks + r0 * ld);
        va.init(Vs + r0 * ld);
      },
      [&](int s, int slot) {
        const int ent = A.map.k_ent[e0 + s], q0 = (ent >> 1) * kTile;
        const float* lse_s = Ls + slot * 2 * kTile;
        const float* di_s = lse_s + kTile;
        ++visited;
        float pt[kNT][4], dpt[kNT][4];  // (key, query)
        band::zero(pt);
        band::zero(dpt);
        band::rows_rows(pt, ka, Qs + slot * TE);
#pragma unroll
        for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int qi = band::acc_col(nb, r);
            float x = pt[nb][r];
            if ((ent & 1) && !band::visible(q0 + qi, k0 + r0 + band::acc_row(r), A.w)) x = kMask;
            pt[nb][r] = band::exp_sfu(x - lse_s[qi]);
          }
        band::acc_cols<T, kD>(dv_acc, pt, Gs + slot * TE);  // dv += rnd(p)·do
        band::rows_rows(dpt, va, Gs + slot * TE);
#pragma unroll
        for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dpt[nb][r] = (dpt[nb][r] - di_s[band::acc_col(nb, r)]) * pt[nb][r];
        band::acc_cols<T, kD>(dk_acc, dpt, Qs + slot * TE);  // dk += rnd(ds)·q
        if (dq_part) {
          // this pair's dq partial, rnd(ds)·k over the tile's 64 keys: every
          // warp's dS rows are needed, each warp takes 16 queries
#pragma unroll
          for (int nb = 0; nb < kNT; ++nb)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              DSs[(r0 + band::acc_row(r)) * dld + band::acc_col(nb, r)] = from_f<T>(dpt[nb][r]);
          __syncthreads();
          float pq[kDB][4];
          band::zero(pq);
          band::cols_cols<T, kD>(pq, DSs, dld, r0, Ks);
          const long long slot_id = A.map.k_slot[e0 + s];
          band::store_rows<T>(dq_part + (slot_id * A.bh + bh) * kTile * kD + r0 * kD, 16, kD, pq,
                              1.f, 1.f);
        }
      });
  band::store_rows<T>(dk + base + (long long)(k0 + r0) * kD, 16, kD, dk_acc, 1.f, 1.f);
  band::store_rows<T>(dv + base + (long long)(k0 + r0) * kD, 16, kD, dv_acc, 1.f, 1.f);
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

// Dynamic shared memory (bytes) of the largest splash kernel (dk/dv) for
// dtype 0 = f32, 1 = bf16.
long long splash_smem_bytes(int dtype) {
  return dtype == 1 ? dkv_smem<__nv_bfloat16>() : dkv_smem<float>();
}

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
