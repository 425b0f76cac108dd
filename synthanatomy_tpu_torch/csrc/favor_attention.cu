// Causal FAVOR+ attention with fused softmax-kernel feature maps, for
// Hopper (sm_90a): forward, and the backward's dq and dk/dv.
//
// Replaces the TPU kernels of synthanatomy_tpu/ops/favor_pallas.py:
// _fwd_kernel (:148), _bwd_dq_kernel (:180) and _bwd_dkv_kernel (:218),
// launched by favor_attention_fused (:428).  Same math and rounding
// points; the plain PyTorch twin is ops/favor_attention.py
// (favor_fwd_plain, favor_bwd_plain).
//
// Two routes, chosen from the shape by favor_plan.h (tile_route):
//   - the chunk-parallel route (favor_core.cuh): d a multiple of 8 up to
//     64 and m up to 256, every shape of the port's models.  Forward: a
//     state launch, the scan, the consumer (3 launches); backward: the
//     state launch (keys and queries), the scan of both directions, dq,
//     dk/dv (4).  bf16 products on the tensor cores.
//   - the earlier kernels below (head_*_kernel) for the rest (d above 64,
//     m above 256, d not a multiple of 8): one block per (batch, head)
//     walking the chunks, the carry S (or dS) and z in shared memory, the
//     per-chunk tiles (features, scores, cotangents; ~0.7 MB per head) in
//     a global workspace that stays in L2, products as f32 FMAs over
//     staged tiles (block_gemm.cuh); forward 1 launch, backward 2.
// Rows past L are absent: the TPU kernel pads them with zeros, and such
// rows change no real output or gradient.
//
// The kernel-body probe's ablations of the route's kernels are built from
// favor_core.cuh by favor_probe_idfeat.cu and favor_probe_nomask.cu.

#include <stdint.h>

#include "block_gemm.cuh"
#include "favor_core.cuh"

using sa::from_f;
using sa::rnd;
using sa::to_f;
using sa::warp_max;
using sa::warp_sum;

namespace {

using G = sa::Gemm<64, 64>;
constexpr int kThreads = G::kThreads;  // 256
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-4f;  // the feature map's epsilon

struct Dims {
  int n, d, m, chunk;
  float dn, half_dn2, dn2, r;  // d^-1/4, dn²/2, dn², m^-1/2 (from the host, in f32)
};

// workspace floats per (batch, head): 4 (chunk x m) + 2 (chunk x chunk) + (chunk x d)
__host__ __device__ inline long long work_per_bh(int chunk, int d, int m) {
  return 4LL * chunk * m + 2LL * chunk * chunk + 1LL * chunk * d;
}

// Shared memory: the carry (m x d, then m), `rows` vectors of `chunk`,
// then the product's staging tiles at a 16-byte boundary (float4 reads).
__host__ __device__ inline int stage_offset(int d, int m, int chunk, int rows) {
  return (m * d + m + rows * chunk + 3) / 4 * 4;
}

// U (c x m) = rnd(x·dn) · rnd(P)ᵀ, x the chunk's c rows (kIdFeat: x · rnd(P)ᵀ)
template <class T>
__device__ void feature_dash(const Dims& D, int c, const T* x, const float* P, float* U,
                             float* stage) {
  const int d = D.d, m = D.m;
  const float dn = D.dn;
  G::run<true, true>(
      c, m, d,
      [&](int i, int k) {
        return rnd<T>(to_f(x[i * d + k]) * dn);
      },
      [&](int k, int f) { return rnd<T>(P[f * d + k]); },
      [&](int i, int f, float acc) { U[i * m + f] = acc; }, stage);
}

// ‖x_i‖²·dn²/2 of one row, by one warp
template <class T>
__device__ float row_diag(const Dims& D, const T* xi) {
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < D.d; k += 32) {
    const float x = to_f(xi[k]);
    s += x * x;
  }
  return warp_sum(s) * D.half_dn2;
}

// Query features of the chunk, one warp per row: E_i = exp(U_i − diag −
// max_f U_i).  QP: write r·(E + ε) into E; otherwise write E.
template <class T, bool QP>
__device__ void query_exp(const Dims& D, int c, const T* q, const float* U, float* E) {
  const int lane = threadIdx.x & 31, m = D.m;
  for (int i = threadIdx.x >> 5; i < c; i += kWarps) {
    const float diag = row_diag<T>(D, q + i * D.d);
    float mx = -INFINITY;
    for (int f = lane; f < m; f += 32) mx = fmaxf(mx, U[i * m + f]);
    mx = warp_max(mx);
    for (int f = lane; f < m; f += 32) {
      const float e = expf(U[i * m + f] - diag - mx);
      E[i * m + f] = QP ? D.r * (e + kEps) : e;
    }
  }
}

// Key features (zero stabilizer), in place: KP: r·(E + ε); otherwise E.
template <class T, bool KP>
__device__ void key_exp(const Dims& D, int c, const T* k, float* U) {
  const int lane = threadIdx.x & 31, m = D.m;
  for (int i = threadIdx.x >> 5; i < c; i += kWarps) {
    const float diag = row_diag<T>(D, k + i * D.d);
    for (int f = lane; f < m; f += 32) {
      const float e = expf(U[i * m + f] - diag);
      U[i * m + f] = KP ? D.r * (e + kEps) : e;
    }
  }
}

// Output cotangent terms, one warp per row: inv = 1/max(den, 1e-12),
// dnum = g·inv (c x d, f32), gd = −(Σ g·out)·inv.
template <class T>
__device__ void out_cotangent(const Dims& D, int c, const T* g, const float* out,
                              const float* den, float* DNUM, float* gd) {
  const int lane = threadIdx.x & 31, d = D.d;
  for (int i = threadIdx.x >> 5; i < c; i += kWarps) {
    const float inv = 1.f / fmaxf(den[i], 1e-12f);
    float s = 0.f;
    for (int e = lane; e < d; e += 32) {
      const float gv = to_f(g[i * d + e]);
      s += gv * out[i * d + e];
      DNUM[i * d + e] = gv * inv;
    }
    s = warp_sum(s);
    if (lane == 0) gd[i] = -s * inv;
  }
}

// DS (c x c) = tril(rnd(dnum)·vᵀ + gd)
template <class T>
__device__ void dscores(const Dims& D, int c, const float* DNUM, const T* v, const float* gd,
                        float* DS, float* stage) {
  const int d = D.d, ch = D.chunk;
  G::run<true, true>(
      c, c, d, [&](int i, int e) { return rnd<T>(DNUM[i * d + e]); },
      [&](int e, int j) { return to_f(v[j * d + e]); },
      [&](int i, int j, float acc) {
        DS[i * ch + j] = j <= i ? acc + gd[i] : 0.f;
      },
      stage);
}

// S += rnd(kp)ᵀ·v and z += Σ_rows kp (kp in f32)
template <class T>
__device__ void prefix_update(const Dims& D, int c, const float* KP, const T* v, float* S,
                              float* z, float* stage) {
  const int d = D.d, m = D.m;
  G::run<false, false>(
      m, d, c, [&](int f, int j) { return rnd<T>(KP[j * m + f]); },
      [&](int j, int e) { return to_f(v[j * d + e]); },
      [&](int f, int e, float acc) { S[f * d + e] += acc; }, stage);
  for (int f = threadIdx.x; f < m; f += kThreads) {
    float s = 0.f;
    for (int j = 0; j < c; ++j) s += KP[j * m + f];
    z[f] += s;
  }
  __syncthreads();
}

// One block's forward sweep over the (batch·head) row bh.
template <class T>
__device__ __forceinline__ void favor_fwd_body(const Dims& D, long long bh,
                                               const T* __restrict__ q,
                                               const T* __restrict__ k,
                                               const T* __restrict__ v,
                                               const float* __restrict__ P, float* out,
                                               float* den, float* work, float* smem) {
  const int n = D.n, d = D.d, m = D.m, ch = D.chunk;
  float* S = smem;           // m x d
  float* z = S + m * d;      // m
  float* inv = z + m;        // chunk
  float* stage = smem + stage_offset(d, m, ch, 1);
  q += bh * n * d;
  k += bh * n * d;
  v += bh * n * d;
  out += bh * n * d;
  den += bh * n;
  float* U = work + bh * work_per_bh(ch, d, m);  // q dash, then qc
  float* KP = U + ch * m;                          // k dash, then kp
  float* SC = KP + ch * m;                         // chunk x chunk
  float* NUM = SC + ch * ch;                       // chunk x d
  for (int i = threadIdx.x; i < m * d; i += kThreads) S[i] = 0.f;
  for (int i = threadIdx.x; i < m; i += kThreads) z[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += ch) {
    const int c = min(ch, n - c0);
    const T* qc = q + c0 * d;
    const T* kc = k + c0 * d;
    const T* vc = v + c0 * d;
    feature_dash<T>(D, c, qc, P, U, stage);
    feature_dash<T>(D, c, kc, P, KP, stage);
    query_exp<T, true>(D, c, qc, U, U);
    key_exp<T, true>(D, c, kc, KP);
    __syncthreads();
    G::run<true, true>(
        c, c, m, [&](int i, int f) { return rnd<T>(U[i * m + f]); },
        [&](int f, int j) { return rnd<T>(KP[j * m + f]); },
        [&](int i, int j, float acc) {
          SC[i * ch + j] = j <= i ? acc : 0.f;
        },
        stage);
    // den = Σ_j scores + rnd(qp)·rnd(z)
    for (int i = threadIdx.x >> 5; i < c; i += kWarps) {
      const int lane = threadIdx.x & 31;
      float s1 = 0.f, s2 = 0.f;
      for (int j = lane; j < c; j += 32) s1 += SC[i * ch + j];
      for (int f = lane; f < m; f += 32) s2 += rnd<T>(U[i * m + f]) * rnd<T>(z[f]);
      const float dv = warp_sum(s1) + warp_sum(s2);
      if (lane == 0) {
        den[c0 + i] = dv;
        inv[i] = 1.f / fmaxf(dv, 1e-12f);
      }
    }
    G::run<true, false>(
        c, d, c, [&](int i, int j) { return rnd<T>(SC[i * ch + j]); },
        [&](int j, int e) { return to_f(vc[j * d + e]); },
        [&](int i, int e, float acc) { NUM[i * d + e] = acc; }, stage);
    G::run<true, false>(
        c, d, m, [&](int i, int f) { return rnd<T>(U[i * m + f]); },
        [&](int f, int e) { return rnd<T>(S[f * d + e]); },
        [&](int i, int e, float acc) {
          out[(c0 + i) * d + e] = (NUM[i * d + e] + acc) * inv[i];
        },
        stage);
    prefix_update<T>(D, c, KP, vc, S, z, stage);
  }
}

// One block's dq sweep over row bh.
template <class T>
__device__ __forceinline__ void favor_bwd_dq_body(const Dims& D, long long bh,
                                                  const T* __restrict__ q,
                                                  const T* __restrict__ k,
                                                  const T* __restrict__ v,
                                                  const float* __restrict__ P,
                                                  const T* __restrict__ g,
                                                  const float* __restrict__ out,
                                                  const float* __restrict__ den, float* dq,
                                                  float* work, float* smem) {
  const int n = D.n, d = D.d, m = D.m, ch = D.chunk;
  float* S = smem;          // m x d
  float* z = S + m * d;     // m
  float* gd = z + m;        // chunk
  float* wr = gd + ch;      // chunk
  float* stage = smem + stage_offset(d, m, ch, 2);
  q += bh * n * d;
  k += bh * n * d;
  v += bh * n * d;
  g += bh * n * d;
  out += bh * n * d;
  den += bh * n;
  dq += bh * n * d;
  float* U = work + bh * work_per_bh(ch, d, m);  // q dash (kept: the tie mask)
  float* E = U + ch * m;  // e_q
  float* KP = U + 2 * ch * m;                      // kp
  float* DQ = KP + ch * m;                         // dq_p, then du
  float* DS = DQ + ch * m;                         // chunk x chunk
  float* DNUM = DS + ch * ch;                      // chunk x d
  for (int i = threadIdx.x; i < m * d; i += kThreads) S[i] = 0.f;
  for (int i = threadIdx.x; i < m; i += kThreads) z[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += ch) {
    const int c = min(ch, n - c0);
    const T* qc = q + c0 * d;
    const T* kc = k + c0 * d;
    const T* vc = v + c0 * d;
    feature_dash<T>(D, c, qc, P, U, stage);
    feature_dash<T>(D, c, kc, P, KP, stage);
    query_exp<T, false>(D, c, qc, U, E);
    key_exp<T, true>(D, c, kc, KP);
    out_cotangent<T>(D, c, g + c0 * d, out + c0 * d, den + c0, DNUM, gd);
    __syncthreads();
    dscores<T>(D, c, DNUM, vc, gd, DS, stage);
    // dq_p = rnd(ds)·rnd(kp) + rnd(dnum)·rnd(S)ᵀ + gd·z
    G::run<true, false>(
        c, m, c, [&](int i, int j) { return rnd<T>(DS[i * ch + j]); },
        [&](int j, int f) { return rnd<T>(KP[j * m + f]); },
        [&](int i, int f, float acc) { DQ[i * m + f] = acc; }, stage);
    G::run<true, true>(
        c, m, d, [&](int i, int e) { return rnd<T>(DNUM[i * d + e]); },
        [&](int e, int f) { return rnd<T>(S[f * d + e]); },
        [&](int i, int f, float acc) { DQ[i * m + f] = (DQ[i * m + f] + acc) + gd[i] * z[f]; },
        stage);
    // through φ_q: dE = dq_p·(r·e_q), w = Σ_f dE, the row-max cotangent
    // −w split evenly over the tied maxima
    for (int i = threadIdx.x >> 5; i < c; i += kWarps) {
      const int lane = threadIdx.x & 31;
      float mx = -INFINITY, w = 0.f, cnt = 0.f;
      for (int f = lane; f < m; f += 32) {
        mx = fmaxf(mx, U[i * m + f]);
        w += DQ[i * m + f] * (D.r * E[i * m + f]);
      }
      mx = warp_max(mx);
      w = warp_sum(w);
      for (int f = lane; f < m; f += 32) cnt += U[i * m + f] == mx ? 1.f : 0.f;
      cnt = warp_sum(cnt);
      const float share = w / cnt;
      for (int f = lane; f < m; f += 32) {
        const float de = DQ[i * m + f] * (D.r * E[i * m + f]);
        DQ[i * m + f] = U[i * m + f] == mx ? de - share : de;
      }
      if (lane == 0) wr[i] = w;
    }
    __syncthreads();
    G::run<true, false>(
        c, d, m, [&](int i, int f) { return rnd<T>(DQ[i * m + f]); },
        [&](int f, int e) { return rnd<T>(P[f * d + e]); },
        [&](int i, int e, float acc) {
          dq[(c0 + i) * d + e] = acc * D.dn - wr[i] * D.dn2 * to_f(qc[i * d + e]);
        },
        stage);
    prefix_update<T>(D, c, KP, vc, S, z, stage);
  }
}

// One block's reverse dk/dv sweep over row bh.
template <class T>
__device__ __forceinline__ void favor_bwd_dkv_body(const Dims& D, long long bh,
                                                   const T* __restrict__ q,
                                                   const T* __restrict__ k,
                                                   const T* __restrict__ v,
                                                   const float* __restrict__ P,
                                                   const T* __restrict__ g,
                                                   const float* __restrict__ out,
                                                   const float* __restrict__ den, float* dk,
                                                   float* dv, float* work, float* smem) {
  const int n = D.n, d = D.d, m = D.m, ch = D.chunk;
  float* dS = smem;          // m x d: Σ over later chunks of rnd(qp)ᵀ·rnd(dnum)
  float* dz = dS + m * d;    // m: Σ over later chunks of qp·gd
  float* gd = dz + m;        // chunk
  float* wr = gd + ch;       // chunk
  float* stage = smem + stage_offset(d, m, ch, 2);
  q += bh * n * d;
  k += bh * n * d;
  v += bh * n * d;
  g += bh * n * d;
  out += bh * n * d;
  den += bh * n;
  dk += bh * n * d;
  dv += bh * n * d;
  float* QP = work + bh * work_per_bh(ch, d, m);  // qp, f32
  float* EK = QP + ch * m;                          // e_k
  float* DK = EK + ch * m;                          // dk_p, then dE
  float* SC = DK + ch * m;                          // chunk x chunk scores
  float* DS = SC + ch * ch;                         // chunk x chunk
  float* DNUM = DS + ch * ch;                       // chunk x d
  for (int i = threadIdx.x; i < m * d; i += kThreads) dS[i] = 0.f;
  for (int i = threadIdx.x; i < m; i += kThreads) dz[i] = 0.f;
  __syncthreads();

  const float r = D.r;
  for (int c0 = ((n - 1) / ch) * ch; c0 >= 0; c0 -= ch) {
    const int c = min(ch, n - c0);
    const T* qc = q + c0 * d;
    const T* kc = k + c0 * d;
    const T* vc = v + c0 * d;
    const T* gc = g + c0 * d;
    feature_dash<T>(D, c, qc, P, QP, stage);
    feature_dash<T>(D, c, kc, P, EK, stage);
    query_exp<T, true>(D, c, qc, QP, QP);
    key_exp<T, false>(D, c, kc, EK);
    out_cotangent<T>(D, c, gc, out + c0 * d, den + c0, DNUM, gd);
    __syncthreads();
    auto kp = [&](int j, int f) { return rnd<T>(r * (EK[j * m + f] + kEps)); };
    G::run<true, true>(
        c, c, m, [&](int i, int f) { return rnd<T>(QP[i * m + f]); },
        [&](int f, int j) { return kp(j, f); },
        [&](int i, int j, float acc) {
          SC[i * ch + j] = j <= i ? acc : 0.f;
        },
        stage);
    dscores<T>(D, c, DNUM, vc, gd, DS, stage);
    // dk_p = rnd(ds)ᵀ·rnd(qp) + v·rnd(dS)ᵀ + dz  (suffix of later chunks)
    G::run<false, false>(
        c, m, c, [&](int j, int i) { return rnd<T>(DS[i * ch + j]); },
        [&](int i, int f) { return rnd<T>(QP[i * m + f]); },
        [&](int j, int f, float acc) { DK[j * m + f] = acc; }, stage);
    G::run<true, true>(
        c, m, d, [&](int j, int e) { return to_f(vc[j * d + e]); },
        [&](int e, int f) { return rnd<T>(dS[f * d + e]); },
        [&](int j, int f, float acc) { DK[j * m + f] = (DK[j * m + f] + acc) + dz[f]; }, stage);
    // dv = rnd(scores)ᵀ·rnd(dnum) + rnd(kp)·rnd(dS)
    G::run<false, false>(
        c, d, c, [&](int j, int i) { return rnd<T>(SC[i * ch + j]); },
        [&](int i, int e) { return rnd<T>(DNUM[i * d + e]); },
        [&](int j, int e, float acc) { dv[(c0 + j) * d + e] = acc; }, stage);
    G::run<true, false>(
        c, d, m, [&](int j, int f) { return kp(j, f); },
        [&](int f, int e) { return rnd<T>(dS[f * d + e]); },
        [&](int j, int e, float acc) { dv[(c0 + j) * d + e] += acc; }, stage);
    // through φ_k (zero stabilizer): dE = dk_p·(r·e_k), w = Σ_f dE
    for (int j = threadIdx.x >> 5; j < c; j += kWarps) {
      const int lane = threadIdx.x & 31;
      float w = 0.f;
      for (int f = lane; f < m; f += 32) {
        const float de = DK[j * m + f] * (r * EK[j * m + f]);
        DK[j * m + f] = de;
        w += de;
      }
      w = warp_sum(w);
      if (lane == 0) wr[j] = w;
    }
    __syncthreads();
    G::run<true, false>(
        c, d, m, [&](int j, int f) { return rnd<T>(DK[j * m + f]); },
        [&](int f, int e) { return rnd<T>(P[f * d + e]); },
        [&](int j, int e, float acc) {
          dk[(c0 + j) * d + e] = acc * D.dn - wr[j] * D.dn2 * to_f(kc[j * d + e]);
        },
        stage);
    // suffix update: dS += rnd(qp)ᵀ·rnd(dnum), dz += Σ_rows qp·gd
    G::run<false, false>(
        m, d, c, [&](int f, int i) { return rnd<T>(QP[i * m + f]); },
        [&](int i, int e) { return rnd<T>(DNUM[i * d + e]); },
        [&](int f, int e, float acc) { dS[f * d + e] += acc; }, stage);
    for (int f = threadIdx.x; f < m; f += kThreads) {
      float s = 0.f;
      for (int i = 0; i < c; ++i) s += QP[i * m + f] * gd[i];
      dz[f] += s;
    }
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
head_fwd_kernel(Dims D, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ P, float* out, float* den,
                 float* work) {
  extern __shared__ float smem[];
  favor_fwd_body<T>(D, blockIdx.x, q, k, v, P, out, den, work, smem);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
head_dq_kernel(Dims D, const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ P,
                    const T* __restrict__ g, const float* __restrict__ out,
                    const float* __restrict__ den, float* dq, float* work) {
  extern __shared__ float smem[];
  favor_bwd_dq_body<T>(D, blockIdx.x, q, k, v, P, g, out, den, dq, work,
                                         smem);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
head_dkv_kernel(Dims D, const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ P,
                     const T* __restrict__ g, const float* __restrict__ out,
                     const float* __restrict__ den, float* dk, float* dv, float* work) {
  extern __shared__ float smem[];
  favor_bwd_dkv_body<T>(D, blockIdx.x, q, k, v, P, g, out, den, dk, dv,
                                          work, smem);
}

size_t smem_bytes(int d, int m, int chunk, int rows) {
  return sizeof(float) * (stage_offset(d, m, chunk, rows) + G::kSmemFloats);
}

// lets a kernel take more than 48 KB of dynamic shared memory
template <class K>
int allow_smem(K kernel, size_t smem) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem)));
}

Dims make_dims(int n, int d, int m, int chunk, float dn, float half_dn2, float dn2, float r) {
  Dims D;
  D.n = n;
  D.d = d;
  D.m = m;
  D.chunk = chunk;
  D.dn = dn;
  D.half_dn2 = half_dn2;
  D.dn2 = dn2;
  D.r = r;
  return D;
}

template <class T>
int earlier_bwd(int parts, const Dims& D, int bh, const void* q, const void* k, const void* v,
                const float* P, const void* g, const float* out, const float* den, float* dq,
                float* dk, float* dv, float* work, cudaStream_t s) {
  const size_t smem = smem_bytes(D.d, D.m, D.chunk, 2);
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *tg = static_cast<const T*>(g);
  if (parts & 1) {
    auto kern = head_dq_kernel<T>;
    if (int e = allow_smem(kern, smem)) return e;
    kern<<<bh, kThreads, smem, s>>>(D, tq, tk, tv, P, tg, out, den, dq, work);
    if (int e = int(cudaGetLastError())) return e;
  }
  if (parts & 2) {
    auto kern = head_dkv_kernel<T>;
    if (int e = allow_smem(kern, smem)) return e;
    kern<<<bh, kThreads, smem, s>>>(D, tq, tk, tv, P, tg, out, den, dk, dv, work);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// 1 where favor_plan.h's chunk-parallel route serves the shape
// (dtype 0 = f32, 1 = bf16 for q, k, v and g)
int favor_route(int d, int m, int chunk, int dtype) {
  return fp::tile_route(d, m, chunk, dtype ? 2 : 4);
}

// Workspace bytes of one forward (bwd 0) or backward (bwd 1) call.
long long favor_work_bytes(int bh, int n, int d, int m, int chunk, int dtype, int bwd) {
  if (fp::tile_route(d, m, chunk, dtype ? 2 : 4))
    return fp::work_bytes(bh, n, chunk, fp::padded_m(m), dtype ? 2 : 4, bwd != 0);
  return 4LL * bh * work_per_bh(chunk, d, m);
}

// Dynamic shared memory of the largest launch that serves the shape
// (bytes); the wrapper refuses shapes above the card's per-block limit.
long long favor_smem_bytes(int d, int m, int chunk, int dtype) {
  if (fp::tile_route(d, m, chunk, dtype ? 2 : 4))
    return fp::route_smem_bytes(dtype ? 2 : 4, fp::padded_m(m));
  return (long long)smem_bytes(d, m, chunk, 2);
}

// Kernel launches of one forward (bwd 0) or backward (bwd 1) call.
int favor_launches(int d, int m, int chunk, int dtype, int bwd) {
  if (fp::tile_route(d, m, chunk, dtype ? 2 : 4)) return bwd ? fp::kBwdLaunches : fp::kFwdLaunches;
  return bwd ? 2 : 1;
}

// The route's launch `kind` (favor_plan.h: 0 state, 2 forward, 3 dq, 4
// dk/dv): dynamic shared memory (bytes) at m's padded width.
long long favor_launch_smem(int kind, int m, int dtype) {
  return fp::smem_bytes(kind, dtype ? 2 : 4, fp::padded_m(m));
}

// out (bh, n, d) f32 and den (bh, n) f32.  Returns a cudaError_t.
int favor_fwd(int bh, int n, int d, int m, int chunk, int dtype, float dn, float half_dn2,
              float dn2, float r, const void* q, const void* k, const void* v, const float* P,
              float* out, float* den, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp::tile_route(d, m, chunk, dtype ? 2 : 4)) {
    const fv::Args A = fv::make_args(bh, n, d, m, chunk, dtype ? 2 : 4, false, dn, half_dn2, dn2,
                                     r, q, k, v, nullptr, P, nullptr, nullptr, out, den, nullptr,
                                     nullptr, nullptr, work);
    return dtype ? fv::run_m<__nv_bfloat16, fv::FavorBody::kFull>(0, 0, A, s)
                 : fv::run_m<float, fv::FavorBody::kFull>(0, 0, A, s);
  }
  const Dims D = make_dims(n, d, m, chunk, dn, half_dn2, dn2, r);
  const size_t smem = smem_bytes(d, m, chunk, 1);
  float* wk = static_cast<float*>(work);
  if (dtype == 1) {
    auto kern = head_fwd_kernel<__nv_bfloat16>;
    if (int e = allow_smem(kern, smem)) return e;
    kern<<<bh, kThreads, smem, s>>>(D, static_cast<const __nv_bfloat16*>(q),
                                    static_cast<const __nv_bfloat16*>(k),
                                    static_cast<const __nv_bfloat16*>(v), P, out, den, wk);
  } else {
    auto kern = head_fwd_kernel<float>;
    if (int e = allow_smem(kern, smem)) return e;
    kern<<<bh, kThreads, smem, s>>>(D, static_cast<const float*>(q),
                                    static_cast<const float*>(k),
                                    static_cast<const float*>(v), P, out, den, wk);
  }
  return int(cudaGetLastError());
}

// The backward: dq (parts bit 0) and dk, dv (bit 1), each (bh, n, d) f32,
// from g in the compute dtype and the forward's out and den.
int favor_bwd(int parts, int bh, int n, int d, int m, int chunk, int dtype, float dn,
              float half_dn2, float dn2, float r, const void* q, const void* k, const void* v,
              const float* P, const void* g, const float* out, const float* den, float* dq,
              float* dk, float* dv, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp::tile_route(d, m, chunk, dtype ? 2 : 4)) {
    const fv::Args A = fv::make_args(bh, n, d, m, chunk, dtype ? 2 : 4, true, dn, half_dn2, dn2,
                                     r, q, k, v, g, P, out, den, nullptr, nullptr, dq, dk, dv,
                                     work);
    return dtype ? fv::run_m<__nv_bfloat16, fv::FavorBody::kFull>(1, parts, A, s)
                 : fv::run_m<float, fv::FavorBody::kFull>(1, parts, A, s);
  }
  const Dims D = make_dims(n, d, m, chunk, dn, half_dn2, dn2, r);
  float* wk = static_cast<float*>(work);
  return dtype ? earlier_bwd<__nv_bfloat16>(parts, D, bh, q, k, v, P, g, out, den, dq, dk, dv,
                                            wk, s)
               : earlier_bwd<float>(parts, D, bh, q, k, v, P, g, out, den, dq, dk, dv, wk, s);
}

}  // extern "C"
