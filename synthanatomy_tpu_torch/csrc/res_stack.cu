// Fused slim residual layer of the VQ-VAE for Hopper (sm_90a): forward
// and a deterministic backward.
//
// Replaces the TPU kernels of synthanatomy_tpu/ops/res_stack_pallas.py:
// _res_kernel (:116, pallas_call :207) and _res_bwd_kernel (:271,
// pallas_call :412), launched by fused_residual_layer (:539).  The plain
// PyTorch twin is ops/res_stack.py (residual_layer_plain,
// residual_layer_bwd_plain).
//
// With x (B, C, D, H, W) in T (bf16 or f32), w1 the 3³ taps, w2 the 1³
// conv and b1 (R,), b2 (C,), all in T:
//
//   h = relu(rnd(rnd(W1 ⊛ x) + b1)),   y = relu(rnd(rnd(rnd(W2·h) + b2) + x))
//
// with every product summed in f32 and rnd rounding to T where the
// Pallas kernel and JAX's module path round: the conv output before the
// bias add, each add in T.  Backward, from saved x, h, y and gy:
//
//   g_r = gy·[y>0];  da = rnd(g_r·W2ᵀ)·[h>0]
//   dx  = rnd(rnd(Σ_t da(· − δ_t)·W1[t]ᵀ) + g_r)   (the tap-reversed conv)
//   dW1[t] = Σ_p x(p + δ_t)ᵀ·da(p),  dW2 = Σ_p hᵀ·g_r,  db1 = Σ da,  db2 = Σ g_r
//
// the weight and bias gradients in f32.
//
// Two routes, chosen from the shape by res_plan.h (tile_route), never
// from a failed launch:
//   - the tile route (bf16, C and R multiples of 8 up to 128: the paper
//     VQ-VAE's fused layers): res_tile.cuh, on channels-last (NDHWC)
//     volumes, halo-staged implicit-GEMM tiles on the tensor cores fed by
//     cp.async rings;
//   - the GEMM route (everything else: f32, odd or wider channels), below,
//     on NCDHW volumes read in place.  Every product goes through one
//     block-wide tiled GEMM whose operand accessors compute the conv taps,
//     masks and layouts: in bf16 a tensor-core product (GemmTC: 64 x 128
//     tiles, mma.sync m16n8k16 with f32 accumulators, operands staged one
//     element per thread); in f32 block_gemm.cuh's FMA product (64 x 64
//     tiles), so that the f32 instantiation stays exact f32.  256 threads
//     either way.  Kernels:
//   res_fwd_kernel     one block per 64 voxels of one volume: the 27-tap
//                      implicit GEMM (K = 27·C, halo and borders masked
//                      in the operand accessor), h kept in shared memory
//                      (and written out when a gradient is wanted), then
//                      the 1³ product, bias, residual and relu;
//   res_bwd_da_kernel  da per 64 voxels (written to a scratch tensor: the
//                      dx conv needs it on the halo);
//   res_bwd_dx_kernel  the tap-reversed implicit GEMM (K = 27·R) + g_r;
//   res_bwd_dw1_kernel one block per (64 x 128 tile of dW1[t] in bf16,
//                      64 x 64 in f32; tap t; chunk of voxels): per-chunk
//                      partial sums;
//   res_bwd_dw2_kernel the same for dW2;
//   res_bwd_bias_kernel per-chunk partial sums of da and g_r per channel;
//   rt::reduce_kernel  sums the partials over the chunks in chunk order.
// No float atomics on either route: two runs give identical bits.
//
// What bounds it on the card: operations.  At the paper shape (C = R =
// 128, 80 x 112 x 80 voxels) the forward is 2·28·C·R ≈ 0.92 MFLOP per
// voxel, 0.66 TFLOP per volume against ~0.37 GB moved in bf16, far above
// the card's ~295 FLOP/byte balance; the backward about twice that.  The
// bound is the bf16 tensor-core rate, 0.66 ms per volume forward.  The
// GEMM route is far from it (its operand staging, one element per thread
// through an accessor, with a synchronous k-loop); the tile route is the
// paper shape's.

#include <stdint.h>

#include <type_traits>

#include "block_gemm.cuh"
#include "res_tile.cuh"

using sa::from_f;
using sa::rnd;
using sa::to_f;

namespace {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// C (M x N) = A (M x K) · B (K x N) on the tensor cores, with the
// interface of sa::Gemm: accessors a(i, k), b(k, j) return the operands
// as f32 (each exactly a bf16 value), epi(i, j, acc) receives every
// output once.  64 x 128 output tiles, 8 warps in 2 x 4, each warp 32 x
// 32 as 2 x 4 m16n8k16 products per 16-deep k-slice; operands staged in
// shared memory as bf16, 32 deep, rows padded to 40 elements (the
// fragment loads of a warp then hit 32 distinct banks).  Sums are f32,
// in a fixed order, so a launch does not depend on scheduling.
template <int TM, int TN>
struct GemmTC {
  static_assert(TM == 64 && TN == 128, "the warp layout covers 64 x 128");
  static constexpr int kThreads = 256;
  static constexpr int kTK = 32;
  static constexpr int kLd = kTK + 8;
  static constexpr int kSmemFloats = (TM + TN) * kLd / 2;
  static constexpr int kTN = TN;

  template <bool A_KFAST, bool B_KFAST, class FA, class FB, class FE>
  __device__ static void run(int M, int N, int K, FA a, FB b, FE epi, float* stage) {
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(stage);  // [TM][kLd]
    __nv_bfloat16* Bs = As + TM * kLd;                             // [TN][kLd]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    for (int i0 = 0; i0 < M; i0 += TM) {
      for (int j0 = 0; j0 < N; j0 += TN) {
        float acc[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
        for (int k0 = 0; k0 < K; k0 += kTK) {
          __syncthreads();
          for (int e = tid; e < TM * kTK; e += kThreads) {
            const int ii = A_KFAST ? e / kTK : e % TM;
            const int kk = A_KFAST ? e % kTK : e / TM;
            const int gi = i0 + ii, gk = k0 + kk;
            As[ii * kLd + kk] = __float2bfloat16((gi < M && gk < K) ? a(gi, gk) : 0.f);
          }
          for (int e = tid; e < TN * kTK; e += kThreads) {
            const int jj = B_KFAST ? e / kTK : e % TN;
            const int kk = B_KFAST ? e % kTK : e / TN;
            const int gj = j0 + jj, gk = k0 + kk;
            Bs[jj * kLd + kk] = __float2bfloat16((gj < N && gk < K) ? b(gk, gj) : 0.f);
          }
          __syncthreads();
#pragma unroll
          for (int ks = 0; ks < kTK; ks += 16) {
            uint32_t af[2][4], bf[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const __nv_bfloat16* p = As + (wm * 32 + mi * 16 + g) * kLd + ks + 2 * t;
              af[mi][0] = ld32(p);
              af[mi][1] = ld32(p + 8 * kLd);
              af[mi][2] = ld32(p + 8);
              af[mi][3] = ld32(p + 8 * kLd + 8);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const __nv_bfloat16* q = Bs + (wn * 32 + ni * 8 + g) * kLd + ks + 2 * t;
              bf[ni][0] = ld32(q);
              bf[ni][1] = ld32(q + 8);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                float* c = acc[mi][ni];
                asm volatile(
                    "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                    "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                    : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                    : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]), "r"(af[mi][3]),
                      "r"(bf[ni][0]), "r"(bf[ni][1]));
              }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + wm * 32 + mi * 16 + g + (r >> 1) * 8;
              const int j = j0 + wn * 32 + ni * 8 + 2 * t + (r & 1);
              if (i < M && j < N) epi(i, j, acc[mi][ni][r]);
            }
      }
    }
    __syncthreads();
  }
};

// the product each instantiation runs: tensor cores for bf16, FMAs for f32
template <class T>
using GemmFor = typename std::conditional<std::is_same<T, float>::value, sa::Gemm<64, 64>,
                                          GemmTC<64, 128>>::type;
constexpr int kThreads = 256;
static_assert(sa::Gemm<64, 64>::kThreads == kThreads && GemmTC<64, 128>::kThreads == kThreads,
              "both products run 256 threads");
constexpr int kTM = 64;                // voxels per block (forward, da, dx)
constexpr int kMaxR = 512;  // ops/res_stack.py _MAX_R: a block's h tile lives in shared memory

struct Vol {
  int B, C, R, D, H, W, S;           // S = D·H·W
  float inv_hw, inv_w, inv_c, inv_r;  // 1/(H·W), 1/W, 1/C, 1/R
};

// q = p / n, r = p % n for 0 ≤ p < 2^24 through a float reciprocal and
// one correction step (exact: the estimate is off by at most one)
__device__ __forceinline__ void divmod(int p, int n, float inv, int& q, int& r) {
  q = __float2int_rz((float)p * inv);
  r = p - q * n;
  if (r < 0) {
    --q;
    r += n;
  } else if (r >= n) {
    ++q;
    r -= n;
  }
}

__device__ __forceinline__ void coords(const Vol& v, int s, int& z, int& y, int& x) {
  int rem;
  divmod(s, v.H * v.W, v.inv_hw, z, rem);
  divmod(rem, v.W, v.inv_w, y, x);
}

__device__ __forceinline__ bool inside(const Vol& v, int z, int y, int x) {
  return (unsigned)z < (unsigned)v.D && (unsigned)y < (unsigned)v.H && (unsigned)x < (unsigned)v.W;
}

// the voxel coordinates of the block's 64 voxels, in shared memory
__device__ __forceinline__ void block_coords(const Vol& v, int m0, int* zc, int* yc, int* xc) {
  for (int i = threadIdx.x; i < kTM; i += blockDim.x) {
    int z = 0, y = 0, x = 0;
    if (m0 + i < v.S) coords(v, m0 + i, z, y, x);
    zc[i] = z;
    yc[i] = y;
    xc[i] = x;
  }
}

template <class T>
__host__ __device__ inline long long fwd_smem_floats(int r) {
  return GemmFor<T>::kSmemFloats + (long long)r * kTM + 3 * kTM;
}

template <class T>
__host__ __device__ inline long long dx_smem_floats() {
  return GemmFor<T>::kSmemFloats + 3 * kTM;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
res_fwd_kernel(Vol v, const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ y,
               T* __restrict__ hout) {
  using G = GemmFor<T>;
  extern __shared__ float sm[];
  float* stage = sm;
  float* hs = stage + G::kSmemFloats;  // [R][kTM]
  int* zc = reinterpret_cast<int*>(hs + (int64_t)v.R * kTM);
  int* yc = zc + kTM;
  int* xc = yc + kTM;
  const int b = blockIdx.y, m0 = blockIdx.x * kTM;
  const int mv = min(kTM, v.S - m0);
  const int C = v.C, R = v.R, S = v.S;
  const int64_t xo = (int64_t)b * C * S;
  block_coords(v, m0, zc, yc, xc);  // Gemm::run syncs before its first read

  auto a1 = [&](int i, int k) -> float {
    int t, c;
    divmod(k, C, v.inv_c, t, c);
    const int z = zc[i] + t / 9 - 1, yy = yc[i] + (t / 3) % 3 - 1, xx = xc[i] + t % 3 - 1;
    if (!inside(v, z, yy, xx)) return 0.f;
    return to_f(x[xo + (int64_t)c * S + (z * v.H + yy) * v.W + xx]);
  };
  auto bw1 = [&](int k, int j) -> float { return to_f(w1[(int64_t)k * R + j]); };
  auto e1 = [&](int i, int j, float acc) {
    hs[j * kTM + i] = fmaxf(rnd<T>(rnd<T>(acc) + to_f(b1[j])), 0.f);
  };
  G::template run<false, false>(mv, R, 27 * C, a1, bw1, e1, stage);

  if (hout != nullptr) {
    const int64_t ho = (int64_t)b * R * S + m0;
    for (int e = threadIdx.x; e < R * mv; e += kThreads) {
      const int j = e / mv, i = e - j * mv;
      hout[ho + (int64_t)j * S + i] = from_f<T>(hs[j * kTM + i]);
    }
  }
  auto a2 = [&](int i, int k) -> float { return hs[k * kTM + i]; };
  auto bw2 = [&](int k, int j) -> float { return to_f(w2[(int64_t)k * C + j]); };
  auto e2 = [&](int i, int j, float acc) {
    const int64_t o = xo + (int64_t)j * S + m0 + i;
    const float yv = rnd<T>(rnd<T>(rnd<T>(acc) + to_f(b2[j])) + to_f(x[o]));
    y[o] = from_f<T>(fmaxf(yv, 0.f));
  };
  G::template run<false, false>(mv, C, R, a2, bw2, e2, stage);
}

// g_r = gy where y > 0, else 0 (gy is already in T)
template <class T>
__device__ __forceinline__ float grad_r(const T* y, const T* gy, int64_t o) {
  return to_f(y[o]) > 0.f ? to_f(gy[o]) : 0.f;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
res_bwd_da_kernel(Vol v, const T* __restrict__ y, const T* __restrict__ gy,
                  const T* __restrict__ h, const T* __restrict__ w2, T* __restrict__ da) {
  using G = GemmFor<T>;
  extern __shared__ float sm[];
  const int b = blockIdx.y, m0 = blockIdx.x * kTM;
  const int mv = min(kTM, v.S - m0);
  const int C = v.C, R = v.R, S = v.S;
  const int64_t yo = (int64_t)b * C * S + m0, ho = (int64_t)b * R * S + m0;
  auto a = [&](int i, int k) -> float { return grad_r(y, gy, yo + (int64_t)k * S + i); };
  auto bw = [&](int k, int j) -> float { return to_f(w2[(int64_t)j * C + k]); };  // W2ᵀ
  auto e = [&](int i, int j, float acc) {
    const int64_t o = ho + (int64_t)j * S + i;
    da[o] = from_f<T>(to_f(h[o]) > 0.f ? acc : 0.f);
  };
  G::template run<false, true>(mv, R, C, a, bw, e, sm);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
res_bwd_dx_kernel(Vol v, const T* __restrict__ da, const T* __restrict__ w1t,
                  const T* __restrict__ y, const T* __restrict__ gy, T* __restrict__ dx) {
  using G = GemmFor<T>;
  extern __shared__ float sm[];
  float* stage = sm;
  int* zc = reinterpret_cast<int*>(stage + G::kSmemFloats);
  int* yc = zc + kTM;
  int* xc = yc + kTM;
  const int b = blockIdx.y, m0 = blockIdx.x * kTM;
  const int mv = min(kTM, v.S - m0);
  const int C = v.C, R = v.R, S = v.S;
  const int64_t xo = (int64_t)b * C * S, dao = (int64_t)b * R * S;
  block_coords(v, m0, zc, yc, xc);

  auto a = [&](int i, int k) -> float {
    int t, r;
    divmod(k, R, v.inv_r, t, r);
    const int z = zc[i] - (t / 9 - 1), yy = yc[i] - ((t / 3) % 3 - 1), xx = xc[i] - (t % 3 - 1);
    if (!inside(v, z, yy, xx)) return 0.f;
    return to_f(da[dao + (int64_t)r * S + (z * v.H + yy) * v.W + xx]);
  };
  auto bw = [&](int k, int j) -> float { return to_f(w1t[(int64_t)k * C + j]); };
  auto e = [&](int i, int j, float acc) {
    const int64_t o = xo + (int64_t)j * S + m0 + i;
    dx[o] = from_f<T>(rnd<T>(acc) + grad_r(y, gy, o));
  };
  G::template run<false, false>(mv, C, 27 * R, a, bw, e, stage);
}

// Partial sums over one chunk of voxels of one volume: blockIdx.z = q =
// volume · nchunk + chunk; the partial slice q starts at part + q·stride.
struct Chunks {
  int chunk, nchunk;
  int64_t stride;
};

template <class T>
__global__ void __launch_bounds__(kThreads)
res_bwd_dw1_kernel(Vol v, Chunks ch, const T* __restrict__ x, const T* __restrict__ da,
                   float* __restrict__ part) {
  using G = GemmFor<T>;
  constexpr int TN = G::kTN;
  extern __shared__ float sm[];
  const int C = v.C, R = v.R, S = v.S;
  const int ntj = (R + TN - 1) / TN;
  const int i0 = (blockIdx.x / ntj) * 64, j0 = (blockIdx.x % ntj) * TN;
  const int t = blockIdx.y, q = blockIdx.z;
  const int b = q / ch.nchunk, p0 = (q % ch.nchunk) * ch.chunk;
  const int kv = min(ch.chunk, S - p0);
  const int dz = t / 9 - 1, dy = (t / 3) % 3 - 1, dxo = t % 3 - 1;
  const int64_t xo = (int64_t)b * C * S, dao = (int64_t)b * R * S + p0;
  auto a = [&](int i, int k) -> float {
    int z, yy, xx;
    coords(v, p0 + k, z, yy, xx);
    z += dz;
    yy += dy;
    xx += dxo;
    if (!inside(v, z, yy, xx)) return 0.f;
    return to_f(x[xo + (int64_t)(i0 + i) * S + (z * v.H + yy) * v.W + xx]);
  };
  auto bw = [&](int k, int j) -> float { return to_f(da[dao + (int64_t)(j0 + j) * S + k]); };
  float* out = part + q * ch.stride + (int64_t)t * C * R;
  auto e = [&](int i, int j, float acc) { out[(int64_t)(i0 + i) * R + j0 + j] = acc; };
  G::template run<true, true>(min(64, C - i0), min(TN, R - j0), kv, a, bw, e, sm);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
res_bwd_dw2_kernel(Vol v, Chunks ch, const T* __restrict__ h, const T* __restrict__ y,
                   const T* __restrict__ gy, float* __restrict__ part) {
  using G = GemmFor<T>;
  constexpr int TN = G::kTN;
  extern __shared__ float sm[];
  const int C = v.C, R = v.R, S = v.S;
  const int ntj = (C + TN - 1) / TN;
  const int i0 = (blockIdx.x / ntj) * 64, j0 = (blockIdx.x % ntj) * TN;
  const int q = blockIdx.z;
  const int b = q / ch.nchunk, p0 = (q % ch.nchunk) * ch.chunk;
  const int kv = min(ch.chunk, S - p0);
  const int64_t ho = (int64_t)b * R * S + p0, yo = (int64_t)b * C * S + p0;
  auto a = [&](int i, int k) -> float { return to_f(h[ho + (int64_t)(i0 + i) * S + k]); };
  auto bw = [&](int k, int j) -> float { return grad_r(y, gy, yo + (int64_t)(j0 + j) * S + k); };
  float* out = part + q * ch.stride + (int64_t)27 * C * R;
  auto e = [&](int i, int j, float acc) { out[(int64_t)(i0 + i) * C + j0 + j] = acc; };
  G::template run<true, true>(min(64, R - i0), min(TN, C - j0), kv, a, bw, e, sm);
}

// blockIdx.x = channel: < R sums da (db1), else g_r (db2)
template <class T>
__global__ void __launch_bounds__(kThreads)
res_bwd_bias_kernel(Vol v, Chunks ch, const T* __restrict__ da, const T* __restrict__ y,
                    const T* __restrict__ gy, float* __restrict__ part) {
  __shared__ float red[kThreads];
  const int C = v.C, R = v.R, S = v.S;
  const int c = blockIdx.x, q = blockIdx.y;
  const int b = q / ch.nchunk, p0 = (q % ch.nchunk) * ch.chunk;
  const int kv = min(ch.chunk, S - p0);
  float s = 0.f;
  if (c < R) {
    const T* src = da + ((int64_t)b * R + c) * S + p0;
    for (int k = threadIdx.x; k < kv; k += kThreads) s += to_f(src[k]);
  } else {
    const int64_t o = ((int64_t)b * C + (c - R)) * S + p0;
    for (int k = threadIdx.x; k < kv; k += kThreads) s += grad_r(y, gy, o + k);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {  // fixed tree order
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) part[q * ch.stride + (int64_t)28 * C * R + c] = red[0];
}

Vol make_vol(int B, int C, int R, int D, int H, int W) {
  Vol v{B, C, R, D, H, W, D * H * W, 1.f / (H * W), 1.f / W, 1.f / C, 1.f / R};
  return v;
}

template <class T>
int fwd(const Vol& v, const void* x, const void* w1, const void* b1, const void* w2,
        const void* b2, void* y, void* h, cudaStream_t s) {
  const size_t smem = sizeof(float) * fwd_smem_floats<T>(v.R);
  cudaError_t e = cudaFuncSetAttribute(res_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((v.S + kTM - 1) / kTM, v.B);
  res_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      v, static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(y),
      static_cast<T*>(h));
  return (int)cudaGetLastError();
}

template <class T>
int bwd(const Vol& v, int chunk, const void* x, const void* h, const void* y, const void* gy,
        const void* w2, const void* w1t, void* dx, void* da, float* part, float* out,
        cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* ht = static_cast<const T*>(h);
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(gy);
  T* dat = static_cast<T*>(da);
  using G = GemmFor<T>;
  const dim3 grid((v.S + kTM - 1) / kTM, v.B);
  const size_t gsm = sizeof(float) * G::kSmemFloats;
  res_bwd_da_kernel<T><<<grid, kThreads, gsm, s>>>(v, yt, gt, ht, static_cast<const T*>(w2), dat);
  int err = (int)cudaGetLastError();
  if (err) return err;
  res_bwd_dx_kernel<T><<<grid, kThreads, sizeof(float) * dx_smem_floats<T>(), s>>>(
      v, dat, static_cast<const T*>(w1t), yt, gt, static_cast<T*>(dx));
  if ((err = (int)cudaGetLastError())) return err;

  const Chunks ch{chunk, (v.S + chunk - 1) / chunk,
                  (int64_t)28 * v.C * v.R + v.R + v.C};
  const int nq = v.B * ch.nchunk;
  const int tn = G::kTN;
  const int tiles1 = ((v.C + 63) / 64) * ((v.R + tn - 1) / tn);
  const int tiles2 = ((v.R + 63) / 64) * ((v.C + tn - 1) / tn);
  res_bwd_dw1_kernel<T><<<dim3(tiles1, 27, nq), kThreads, gsm, s>>>(v, ch, xt, dat, part);
  if ((err = (int)cudaGetLastError())) return err;
  res_bwd_dw2_kernel<T><<<dim3(tiles2, 1, nq), kThreads, gsm, s>>>(v, ch, ht, yt, gt, part);
  if ((err = (int)cudaGetLastError())) return err;
  res_bwd_bias_kernel<T><<<dim3(v.R + v.C, nq), kThreads, 0, s>>>(v, ch, dat, yt, gt, part);
  if ((err = (int)cudaGetLastError())) return err;
  return rt::reduce(part, nq, ch.stride, out, s);
}

}  // namespace

extern "C" {

// 1 if (C, R) in dtype (0 = f32, 1 = bf16) takes the tile route
// (res_tile.cuh: channels-last volumes), 0 for the GEMM route (NCDHW).
int res_route(int c, int r, int dtype) { return rp::tile_route(c, r, dtype == 1 ? 2 : 4); }

// The largest dynamic shared memory (bytes) of the route's launches.
long long res_smem_bytes(int c, int r, int dtype) {
  if (res_route(c, r, dtype)) return rp::kMaxSmem;
  return (long long)sizeof(float) *
         (dtype == 1 ? fwd_smem_floats<__nv_bfloat16>(r) : fwd_smem_floats<float>(r));
}

// Floats of the backward's partial-sum scratch (chunk: voxels per
// partial on the GEMM route).
long long res_part_floats(int B, int C, int R, int D, int H, int W, int dtype, int chunk) {
  if (res_route(C, R, dtype)) return rp::part_floats(B, C, R, D, H, W);
  const long long S = (long long)D * H * W;
  return B * ((S + chunk - 1) / chunk) * (28LL * C * R + R + C);
}

// dtype: 0 = f32, 1 = bf16.  h may be null (no gradient wanted).  On the
// tile route x, y and h are NDHWC, w1 (27, R, C) and w2 (C, R); on the
// GEMM route NCDHW, (27, C, R) and (R, C).  Returns a cudaError_t.
int res_fwd(int B, int C, int R, int D, int H, int W, int dtype, const void* x, const void* w1,
            const void* b1, const void* w2, const void* b2, void* y, void* h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res_route(C, R, dtype)) {
    using rt::bf16;
    return rt::fwd(rt::Geo{B, D, H, W}, C, R, static_cast<const bf16*>(x),
                   static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                   static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                   static_cast<bf16*>(y), static_cast<bf16*>(h), s);
  }
  const Vol v = make_vol(B, C, R, D, H, W);
  return dtype == 1 ? fwd<__nv_bfloat16>(v, x, w1, b1, w2, b2, y, h, s)
                    : fwd<float>(v, x, w1, b1, w2, b2, y, h, s);
}

// The tile route: five launches (da with the dW2 / db partials, dx, the
// dW1 partials, two reductions); x, h, y, gy, dx and da NDHWC, w2t W2ᵀ
// (R, C), w1 (27, C, R).  The GEMM route: seven launches (da, dx, the
// dW1 / dW2 / bias partials, the reduction); NCDHW, w2t (R, C), w1 (27,
// R, C).  da (the shape of h) and part (res_part_floats) are scratch;
// out (28·C·R + R + C) f32 receives [dW1 (27, C, R) | dW2 (R, C) | db1
// (R) | db2 (C)].
int res_bwd(int B, int C, int R, int D, int H, int W, int dtype, int chunk, const void* x,
            const void* h, const void* y, const void* gy, const void* w2t, const void* w1,
            void* dx, void* da, void* part, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (res_route(C, R, dtype)) {
    using rt::bf16;
    return rt::bwd(rt::Geo{B, D, H, W}, C, R, static_cast<const bf16*>(x),
                   static_cast<const bf16*>(h), static_cast<const bf16*>(y),
                   static_cast<const bf16*>(gy), static_cast<const bf16*>(w2t),
                   static_cast<const bf16*>(w1), static_cast<bf16*>(dx), static_cast<bf16*>(da),
                   p, o, s);
  }
  const Vol v = make_vol(B, C, R, D, H, W);
  return dtype == 1 ? bwd<__nv_bfloat16>(v, chunk, x, h, y, gy, w2t, w1, dx, da, p, o, s)
                    : bwd<float>(v, chunk, x, h, y, gy, w2t, w1, dx, da, p, o, s);
}

}  // extern "C"
