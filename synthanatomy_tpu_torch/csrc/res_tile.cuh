// Row 7's tensor-core tile route for Hopper (sm_90a): the fused slim
// residual layer on channels-last bf16 volumes, forward and backward.
// res_stack.cu launches it for the shapes res_plan.h admits (bf16, C and
// R multiples of 8 up to 128) and keeps its GEMM kernels for the rest.
//
// Replaces, like res_stack.cu, the TPU kernels of
// synthanatomy_tpu/ops/res_stack_pallas.py: _res_kernel (:116) and
// _res_bwd_kernel (:271).  The Pallas kernel stages one halo window of
// the volume in VMEM and lets all 27 taps read it; here the same idea is
// built from what Hopper offers.
//
// Layout.  x, h, y, gy, da and dx are NDHWC (PyTorch's channels_last_3d
// strides), so a voxel's channels are one contiguous row of 16-byte
// chunks, and a tap's shift is a whole row of a staged window: every
// ldmatrix row address stays 16-byte aligned for every tap.  Staged rows
// are XOR-swizzled (res_plan.h swz), so the 8 rows an ldmatrix phase reads
// fall on distinct banks.
//
// The halo core (forward and dx).  A block is one warpgroup (128
// threads) and owns a 4 x 4 x 8 tile of voxels (128, the product's M) and
// all N ≤ 128 output channels.  For each 64-channel chunk of K it stages
// the tile's 6 x 6 x 10 halo window by 16-byte cp.async (voxels outside
// the volume and channels past K are zero-filled through the copy's
// source size, never masked element by element); then its 27 taps, each
// one weight slice (128 x 64) streamed through a 3-slot cp.async ring, so
// the copies of the next two slices are in flight while a slice is
// multiplied (on the card neither a fourth slot nor letting a step's
// products run on under the next step's loads measured faster).  Every
// tap reads its A fragments by ldmatrix from rows of the one window
// shifted by the tap's offset; its products are wgmma m64n128k16 (bf16, f32 sums) with A from
// those registers and B, the slice, read from shared memory by
// descriptor: the slice's 128-byte rows are laid out in wgmma's 128-byte
// swizzle, which is also the XOR swizzle every staged tile here uses.
// Two blocks an SM (registers).
//
//   res_tile_fwd_kernel  h = relu(rnd(rnd(W1 ⊛ x) + b1)) into a bf16 h tile
//                        in shared memory (and out, when a gradient is
//                        wanted); then the 1³ product with W2 (staged once
//                        a block, mma.sync), y = relu(rnd(rnd(rnd(W2·h) +
//                        b2) + x)), stored 16 bytes a thread;
//   res_tile_da_kernel   one block per chunk of 128-voxel sub-tiles: y, gy
//                        and h staged by cp.async (two slots), g_r =
//                        gy·[y > 0] in place, da = rnd(g_r·W2ᵀ)·[h > 0], and
//                        the chunk's dW2 = Σ hᵀ·g_r (in registers across the
//                        chunk), db1 = Σ da and db2 = Σ g_r partials;
//   res_tile_dx_kernel   dx = rnd(rnd(Σ_t da(· − δ_t)·W1[t]ᵀ) + g_r): the
//                        halo core over da, taps reversed (K = R);
//   res_tile_dw1_kernel  one block per (chunk of tiles, tap group, 64
//                        channels of x): the three taps that share a z/y
//                        shift read one staged x window (shifted 0, 1 or 2
//                        rows) and one staged da tile (a 4-slot ring), a
//                        warpgroup a tap, each summing its dW1[t] tile in
//                        registers across the chunk (wgmma, da as an
//                        MN-major B): x is read once per group, not once
//                        per tap;
//   reduce_kernel        sums the partials over the chunks in chunk order.
//
// Rounding is the plain version's (ops/res_stack.py): every product sums
// in f32, the conv output is rounded to bf16 before its bias is added, and
// the adds, relus and the residual are in bf16.  No float atomics: two
// runs give identical bits.
//
// What bounds it: operations (2·28·C·R per voxel forward, twice that
// backward, at the bf16 tensor-core rate: 0.665 ms a paper volume
// forward).  What holds the kernels from it (PERF.md §6, row 7): in the
// halo core the weight slices' traffic from L2 (each 128-voxel block
// streams all of W1), and the staging, products and epilogue of a block
// running one after another, which two blocks an SM overlap only in
// part; in dW1 the traffic of its staging (each da tile is read by 18
// blocks) around its products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_gemm.cuh"
#include "mma_frag.cuh"
#include "res_plan.h"

namespace rt {

using bf16 = __nv_bfloat16;
using sa::rnd;
using sa::to_f;

struct Geo {
  int B, D, H, W;
};

__device__ __forceinline__ bool inside(const Geo& g, int z, int y, int x) {
  return (unsigned)z < (unsigned)g.D && (unsigned)y < (unsigned)g.H && (unsigned)x < (unsigned)g.W;
}

// the flat NDHWC voxel index
__device__ __forceinline__ long long vox(const Geo& g, int b, int z, int y, int x) {
  return (((long long)b * g.D + z) * g.H + y) * g.W + x;
}

// tile voxel m of the tile at o: its flat index, or −1 outside the volume
__device__ __forceinline__ long long tile_vox(const Geo& g, const rp::Origin& o, int m) {
  const int z = o.z0 + rp::tile_z(m), y = o.y0 + rp::tile_y(m), x = o.x0 + rp::tile_x(m);
  return inside(g, z, y, x) ? vox(g, o.b, z, y, x) : -1;
}

// 8 bf16 values (16 bytes) ↔ f32
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  v.x = frag::pack(f[0], f[1]);
  v.y = frag::pack(f[2], f[3]);
  v.z = frag::pack(f[4], f[5]);
  v.w = frag::pack(f[6], f[7]);
  return v;
}

__device__ __forceinline__ float rb(float v) { return rnd<bf16>(v); }

// a bias entry as f32, 0 past n
__device__ __forceinline__ float bias_at(const bf16* __restrict__ b, int j, int n) {
  return j < n ? to_f(b[j]) : 0.f;
}

// The accumulator layout of a 128 x 128 block product with MI m16 tiles
// a warp: the warps form kWM (128 / 16·MI) rows by 2 columns; warp (wm =
// warp % kWM, wn = warp / kWM), lane (g = lane / 4, t = lane % 4) holds
// rows 16·MI·wm + 16mi + g + 8hh, columns wn·64 + 8nj + 2t + {0, 1} in
// acc[mi][nj][2hh + {0, 1}].  MI 4 (the halo core: 4 warps of 64 x 64)
// reads 8 fragments by ldmatrix for 32 products, MI 2 (8 warps of 32 x
// 64) 6 for 16.
template <int MI>
struct Frag {
  static constexpr int kWM = rp::kNP / (16 * MI);
  static constexpr int kThreads = 32 * 2 * kWM;
  int lane, wm, wn, g, t;
  __device__ __forceinline__ Frag() {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    wm = warp % kWM;
    wn = warp / kWM;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ __forceinline__ int row(int mi, int hh) const { return wm * 16 * MI + mi * 16 + g + 8 * hh; }
  __device__ __forceinline__ int col(int nj) const { return wn * 64 + nj * 8 + 2 * t; }
  // the ldmatrix row of A (m16 x k16, plain) and its chunk half; of B (two
  // n8 tiles x k16 from [n][k] rows, plain) and its chunk half
  __device__ __forceinline__ int a_row(int mi) const {
    return wm * 16 * MI + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  }
  __device__ __forceinline__ int a_hi() const { return lane >> 4; }
  __device__ __forceinline__ int b_row(int p) const { return wn * 64 + p * 16 + (lane & 7) + (lane >> 4) * 8; }
  __device__ __forceinline__ int b_hi() const { return (lane >> 3) & 1; }
};
using CoreFrag = Frag<4>;
using DaFrag = Frag<2>;
static_assert(CoreFrag::kThreads == rp::kCoreThreads && DaFrag::kThreads == rp::kThreads,
              "the plan's block sizes");

template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][8][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][nj][r] = 0.f;
}

// one k16 step of a warp's 16·MI x 64 product from fragments
template <int MI>
__device__ __forceinline__ void mma_x8(float (&acc)[MI][8][4], const uint32_t (&a)[MI][4],
                                       const uint32_t (&b)[4][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
      frag::mma(acc[mi][nj], a[mi], b[nj >> 1][(nj & 1) * 2], b[nj >> 1][(nj & 1) * 2 + 1]);
}

// acc += A·Bᵀ over k16 steps [0, ks): A rows a_rows (128-column rows of
// sa), B rows [n][k] (128-column rows of sb), both swizzled
template <int MI>
__device__ __forceinline__ void tile_product(float (&acc)[MI][8][4], const Frag<MI>& f,
                                             const bf16* sa, const bf16* sb, int ks) {
  for (int k = 0; k < ks; ++k) {
    uint32_t a[MI][4], b[4][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int r = f.a_row(mi);
      frag::ldsm4(a[mi], sa + r * rp::kNP + rp::swz(r, 2 * k + f.a_hi()) * 8);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = f.b_row(p);
      frag::ldsm4(b[p], sb + r * rp::kNP + rp::swz(r, 2 * k + f.b_hi()) * 8);
    }
    mma_x8(acc, a, b);
  }
}

// every pair of acc as bf16 into a 128 x 128 staged tile: fn(row, col, v0, v1) → (o0, o1)
template <int MI, class F>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[MI][8][4], const Frag<MI>& f,
                                            bf16* tile, F fn) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = f.row(mi, hh), c = f.col(nj);
        float o0, o1;
        fn(m, c, acc[mi][nj][2 * hh], acc[mi][nj][2 * hh + 1], o0, o1);
        *reinterpret_cast<uint32_t*>(tile + rp::elem_at(m, c, rp::kNP)) = frag::pack(o0, o1);
      }
}

// ---------------------------------------------------------------------------
// the halo core
// ---------------------------------------------------------------------------

// chunk kc of src's K channels over the halo window of the tile at o
__device__ __forceinline__ void stage_window(bf16* win, const bf16* __restrict__ src, int K, int kc,
                                             const Geo& g, const rp::Origin& o) {
  for (int e = threadIdx.x; e < rp::kWin * 8; e += rp::kCoreThreads) {
    const int v = e >> 3, j = e & 7;
    const int z = o.z0 - 1 + v / (rp::kWY * rp::kWX), y = o.y0 - 1 + v / rp::kWX % rp::kWY,
              x = o.x0 - 1 + v % rp::kWX;
    const int k = kc * rp::kKC + j * 8;
    const bool ok = inside(g, z, y, x) && k < K;
    frag::cp_async16(win + v * rp::kKC + rp::swz(v, j) * 8,
                     ok ? src + vox(g, o.b, z, y, x) * K + k : src, ok);
  }
}

// the weight slice (tap t, chunk kc) of wt (27, N, K): rows n < 128, K
// columns kc·64 … kc·64 + 63
__device__ __forceinline__ void stage_slice(bf16* dst, const bf16* __restrict__ wt, int N, int K,
                                            int t, int kc) {
  for (int e = threadIdx.x; e < rp::kNP * 8; e += rp::kCoreThreads) {
    const int n = e >> 3, j = e & 7, k = kc * rp::kKC + j * 8;
    const bool ok = n < N && k < K;
    frag::cp_async16(dst + n * rp::kKC + rp::swz(n, j) * 8,
                     ok ? wt + ((long long)t * N + n) * K + k : wt, ok);
  }
}

// The halo core's accumulators: two m64 x n128 warpgroup products (rows
// 64·hf + …), each in wgmma's layout: warp w, lane (g = lane / 4, t =
// lane % 4) holds rows 64·hf + 16w + g + 8hh, columns 8j + 2t + {0, 1} in
// acc[hf][4j + 2hh + {0, 1}].
struct CoreAcc {
  float v[2][64];
};

__device__ __forceinline__ int core_row(int hf, int hh) {
  return 64 * hf + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * hh;
}
__device__ __forceinline__ int core_col(int j) { return 8 * j + 2 * (threadIdx.x & 3); }

// every pair of the core's sums as bf16 into a 128 x 128 staged tile:
// fn(row, col, v0, v1) → (o0, o1)
template <class F>
__device__ __forceinline__ void core_to_tile(const CoreAcc& acc, bf16* tile, F fn) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = core_row(hf, hh), c = core_col(j);
        float o0, o1;
        fn(m, c, acc.v[hf][4 * j + 2 * hh], acc.v[hf][4 * j + 2 * hh + 1], o0, o1);
        *reinterpret_cast<uint32_t*>(tile + rp::elem_at(m, c, rp::kNP)) = frag::pack(o0, o1);
      }
}

// acc = Σ_t src(p + δ_t)·wt[t]ᵀ over the tile at o (δ_t reversed, −δ_t,
// for dx), src (·, K) NDHWC and wt (27, N, K).  The block is one
// warpgroup: each step's A fragments come by ldmatrix from the window's
// rows shifted by the tap, and its products are wgmma m64n128k16 with B,
// the step's weight slice, read from the ring by descriptor (the slice's
// rows of 128 bytes are in wgmma's 128-byte swizzle).  A slot is refilled
// only after the products that read it are waited for.  Leaves shared
// memory in use: the caller syncs before it writes there.
template <bool kReverse>
__device__ __forceinline__ void halo_core(CoreAcc& acc, const bf16* __restrict__ src, int K,
                                          const bf16* __restrict__ wt, int N, const Geo& g,
                                          const rp::Origin& o, unsigned char* smem) {
  bf16* win = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + rp::kWinBytes);
  constexpr int kSlice = rp::kSliceBytes / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int arow[2];  // this lane's ldmatrix row of each m64 half, at the tap's centre
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    arow[hf] = rp::win_centre(64 * hf + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8);
  const int ahi = lane >> 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc.v[hf][i] = 0.f;

  constexpr int kAhead = rp::kStages - 1;  // slices in flight ahead of a step
  const int steps = rp::core_steps(K);
  stage_window(win, src, K, 0, g, o);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < steps) stage_slice(ring + s * kSlice, wt, N, K, s % 27, s / 27);
    frag::cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int kc = s / 27, t = s - kc * 27;
    if (t == 0 && kc > 0) {  // a new chunk: its window, once the last one is read
      __syncthreads();
      stage_window(win, src, K, kc, g, o);
      frag::cp_commit();
      frag::cp_wait<0>();
    } else {
      frag::cp_wait<kAhead - 1>();
    }
    frag::wg_wait<0>();  // step s − 1's products are done: its slot is free
    frag::wg_fence_operand(acc.v[0]);
    frag::wg_fence_operand(acc.v[1]);
    __syncthreads();  // step s's slice and window are in
    if (s + kAhead < steps) {
      const int s2 = s + kAhead, kc2 = s2 / 27;
      stage_slice(ring + (s2 % rp::kStages) * kSlice, wt, N, K, s2 - kc2 * 27, kc2);
    }
    frag::cp_commit();

    // every step runs its four k16 products: channels past K are zeros in
    // the window and the slice, and a branch around a product would make
    // the compiler serialize them all
    const bf16* slot = ring + (s % rp::kStages) * kSlice;
    const int shift = rp::tap_shift(kReverse ? 26 - t : t);
    uint32_t a[rp::kKC / 16][2][4];
#pragma unroll
    for (int k = 0; k < rp::kKC / 16; ++k)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int v = arow[hf] + shift;
        frag::ldsm4(a[k][hf], win + v * rp::kKC + rp::swz(v, 2 * k + ahi) * 8);
      }
    frag::wg_fence();
#pragma unroll
    for (int k = 0; k < rp::kKC / 16; ++k)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        frag::wg_mma_rs<0>(acc.v[hf], a[k][hf], frag::wg_desc_sw128(slot, 32 * k, 16, 1024));
    frag::wg_commit();
  }
  frag::wg_wait<0>();
  frag::wg_fence_operand(acc.v[0]);
  frag::wg_fence_operand(acc.v[1]);
  frag::cp_wait<0>();
}

// The forward's and dx's last pass over a tile: for each 16-byte chunk of
// a voxel's C channels, fn(a, in) turns the staged values a (8, f32) and
// the chunk's kIn inputs from global memory (NDHWC) into the output, which
// is stored 16 bytes a thread.  The inputs' loads go out 8 chunks at a
// time, ahead of their use.
template <int kIn, class F>
__device__ __forceinline__ void finish_tile(const Geo& g, const rp::Origin& o, int C,
                                            const bf16* st, const bf16* const (&in)[kIn],
                                            bf16* __restrict__ out, F fn) {
  constexpr int kPer = rp::kTM * 16 / rp::kCoreThreads, kBatch = 8;
#pragma unroll
  for (int b0 = 0; b0 < kPer; b0 += kBatch) {
    uint4 v[kBatch][kIn];
    long long off[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = threadIdx.x + (b0 + i) * rp::kCoreThreads, j = e & 15;
      const long long p = tile_vox(g, o, e >> 4);
      off[i] = p >= 0 && j * 8 < C ? p * C + j * 8 : -1;
      if (off[i] >= 0)
#pragma unroll
        for (int k = 0; k < kIn; ++k) v[i][k] = *reinterpret_cast<const uint4*>(in[k] + off[i]);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (off[i] < 0) continue;
      const int e = threadIdx.x + (b0 + i) * rp::kCoreThreads;
      float a[8];
      unpack8(*reinterpret_cast<const uint4*>(st + rp::elem_at(e >> 4, (e & 15) * 8, rp::kNP)), a);
      fn(a, v[i]);
      *reinterpret_cast<uint4*>(out + off[i]) = pack8(a);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// x, y (B, D, H, W, C) and hout (B, D, H, W, R) NDHWC; w1 (27, R, C); w2
// (C, R); b1 (R), b2 (C).  hout may be null.
__global__ void __launch_bounds__(rp::kCoreThreads, 2)
res_tile_fwd_kernel(Geo g, int C, int R, const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ y, bf16* __restrict__ hout) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const rp::Origin o = rp::tile_origin(blockIdx.x, g.D, g.H, g.W);
  CoreAcc core;
  halo_core<false>(core, x, C, w1, R, g, o, smem);
  __syncthreads();  // the window and the ring are free

  bf16* ht = reinterpret_cast<bf16*>(smem);                  // h tile [m][r], later y's
  bf16* w2s = reinterpret_cast<bf16*>(smem + rp::kWinBytes);  // W2 [c][r]
  for (int e = threadIdx.x; e < rp::kNP * 16; e += rp::kCoreThreads) {
    const int n = e >> 4, j = e & 15;
    const bool ok = n < C && j * 8 < R;
    frag::cp_async16(w2s + rp::elem_at(n, j * 8, rp::kNP), ok ? w2 + (long long)n * R + j * 8 : w2,
                     ok);
  }
  frag::cp_commit();
  core_to_tile(core, ht, [&](int, int c, float v0, float v1, float& o0, float& o1) {
    o0 = fmaxf(rb(rb(v0) + bias_at(b1, c, R)), 0.f);
    o1 = fmaxf(rb(rb(v1) + bias_at(b1, c + 1, R)), 0.f);
  });
  frag::cp_wait<0>();
  __syncthreads();

  if (hout != nullptr) {
    for (int e = threadIdx.x; e < rp::kTM * 16; e += rp::kCoreThreads) {
      const int m = e >> 4, j = e & 15;
      const long long p = tile_vox(g, o, m);
      if (p >= 0 && j * 8 < R)
        *reinterpret_cast<uint4*>(hout + p * R + j * 8) =
            *reinterpret_cast<const uint4*>(ht + rp::elem_at(m, j * 8, rp::kNP));
    }
  }
  const CoreFrag f;  // the 1³ product: mma.sync, 4 warps of 64 x 64
  float acc[4][8][4];
  zero(acc);
  tile_product(acc, f, ht, w2s, (R + 15) / 16);
  __syncthreads();  // h is read
  acc_to_tile(acc, f, ht, [&](int, int c, float v0, float v1, float& o0, float& o1) {
    o0 = rb(rb(v0) + bias_at(b2, c, C));
    o1 = rb(rb(v1) + bias_at(b2, c + 1, C));
  });
  __syncthreads();
  const bf16* const ins[1] = {x};
  finish_tile(g, o, C, ht, ins, y, [](float (&a)[8], const uint4 (&v)[1]) {
    float r[8];
    unpack8(v[0], r);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = fmaxf(rb(a[i] + r[i]), 0.f);
  });
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// da (flat voxels, R) with the chunk's partials: part + q·(R·C + R + C)
// receives [dW2 (R, C) | db1 (R) | db2 (C)].  w2t is W2ᵀ (R, C); chunk is
// the sub-tiles of 128 voxels in a chunk.  A sub-tile's y, gy and h come
// by cp.async into one of two slots while the one before is multiplied;
// g_r replaces y in place, and da takes gy's place.
__global__ void __launch_bounds__(rp::kThreads, 1)
res_tile_da_kernel(int C, int R, long long nvox, int chunk, const bf16* __restrict__ y,
                   const bf16* __restrict__ gy, const bf16* __restrict__ h,
                   const bf16* __restrict__ w2t, bf16* __restrict__ da, float* __restrict__ part) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kTile = rp::kTM * rp::kNP;      // elements of one staged tile
  bf16* w2s = reinterpret_cast<bf16*>(smem);  // W2ᵀ [r][c]
  const DaFrag f;
  const int tid = threadIdx.x;
  for (int e = tid; e < rp::kNP * 16; e += rp::kThreads) {
    const int n = e >> 4, j = e & 15;
    const bool ok = n < R && j * 8 < C;
    frag::cp_async16(w2s + rp::elem_at(n, j * 8, rp::kNP), ok ? w2t + (long long)n * C + j * 8 : w2t,
                     ok);
  }
  const long long nsub = (nvox + rp::kTM - 1) / rp::kTM;
  const long long s0 = (long long)blockIdx.x * chunk;
  const long long s1 = s0 + chunk < nsub ? s0 + chunk : nsub;
  // slot i: y (then g_r), gy (then da) and h, each [p][channel]
  auto stage = [&](long long sub, int slot) {
    bf16* ys = w2s + kTile * (1 + 3 * slot);
    const long long p0 = sub * rp::kTM;
    for (int e = tid; e < rp::kTM * 16; e += rp::kThreads) {
      const int p = e >> 4, j = e & 15, o = rp::elem_at(p, j * 8, rp::kNP);
      const bool okc = p0 + p < nvox && j * 8 < C, okr = p0 + p < nvox && j * 8 < R;
      frag::cp_async16(ys + o, okc ? y + (p0 + p) * C + j * 8 : y, okc);
      frag::cp_async16(ys + kTile + o, okc ? gy + (p0 + p) * C + j * 8 : gy, okc);
      frag::cp_async16(ys + 2 * kTile + o, okr ? h + (p0 + p) * R + j * 8 : h, okr);
    }
  };
  if (s0 < s1) stage(s0, 0);
  frag::cp_commit();  // with W2ᵀ

  float accw[2][8][4], acc[2][8][4];
  zero(accw);
  float colsum = 0.f;  // db1 (threads < 128) or db2 (the rest) of one channel
  for (long long sub = s0; sub < s1; ++sub) {
    const int slot = int(sub - s0) & 1;
    if (sub + 1 < s1) stage(sub + 1, slot ^ 1);
    frag::cp_commit();
    frag::cp_wait<1>();
    __syncthreads();
    bf16* gr = w2s + kTile * (1 + 3 * slot);  // y, then g_r [p][c]; gy, then da [p][r]
    bf16* hs = gr + 2 * kTile;
    for (int e = tid; e < rp::kTM * 16; e += rp::kThreads) {  // g_r = gy·[y > 0] in place
      const int o = rp::elem_at(e >> 4, (e & 15) * 8, rp::kNP);
      float yv[8], r[8];
      unpack8(*reinterpret_cast<const uint4*>(gr + o), yv);
      unpack8(*reinterpret_cast<const uint4*>(gr + kTile + o), r);
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = yv[k] > 0.f ? r[k] : 0.f;
      *reinterpret_cast<uint4*>(gr + o) = pack8(r);
    }
    __syncthreads();

    const long long p0 = sub * rp::kTM;
    if (tid >= rp::kNP && tid - rp::kNP < C)
      for (int p = 0; p < rp::kTM; ++p) colsum += to_f(gr[rp::elem_at(p, tid - rp::kNP, rp::kNP)]);
    zero(acc);
    tile_product(acc, f, gr, w2s, (C + 15) / 16);  // g_r·W2ᵀ: M voxels, N = R
    // dW2 += hᵀ·g_r: M = R, N = C, K = the 128 voxels (fragments by ldmatrix.trans)
    for (int k = 0; k < rp::kTM / 16; ++k) {
      uint32_t a[2][4], b[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int p = 16 * k + (f.lane & 7) + (f.lane >> 4) * 8;
        const int m = f.wm * 32 + mi * 16 + ((f.lane >> 3) & 1) * 8;
        frag::ldsm4_t(a[mi], hs + rp::elem_at(p, m, rp::kNP));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = 16 * k + (f.lane & 7) + ((f.lane >> 3) & 1) * 8;
        const int n = f.wn * 64 + q * 16 + (f.lane >> 4) * 8;
        frag::ldsm4_t(b[q], gr + rp::elem_at(p, n, rp::kNP));
      }
      mma_x8(accw, a, b);
    }
    bf16* dt = gr + kTile;  // gy is spent: da goes here
    acc_to_tile(acc, f, dt, [&](int m, int c, float v0, float v1, float& o0, float& o1) {
      o0 = to_f(hs[rp::elem_at(m, c, rp::kNP)]) > 0.f ? v0 : 0.f;
      o1 = to_f(hs[rp::elem_at(m, c + 1, rp::kNP)]) > 0.f ? v1 : 0.f;
    });
    __syncthreads();
    for (int e = tid; e < rp::kTM * 16; e += rp::kThreads) {
      const int p = e >> 4, j = e & 15;
      if (p0 + p < nvox && j * 8 < R)
        *reinterpret_cast<uint4*>(da + (p0 + p) * R + j * 8) =
            *reinterpret_cast<const uint4*>(dt + rp::elem_at(p, j * 8, rp::kNP));
    }
    if (tid < R)
      for (int p = 0; p < rp::kTM; ++p) colsum += to_f(dt[rp::elem_at(p, tid, rp::kNP)]);
    __syncthreads();  // the slot is refilled on the next sub-tile
  }
  frag::cp_wait<0>();

  float* out = part + (long long)blockIdx.x * rp::part2_floats(C, R);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = f.row(mi, hh), c = f.col(nj);
        if (r < R && c < C)
          *reinterpret_cast<float2*>(out + (long long)r * C + c) =
              make_float2(accw[mi][nj][2 * hh], accw[mi][nj][2 * hh + 1]);
      }
  if (tid < R) out[(long long)R * C + tid] = colsum;
  if (tid >= rp::kNP && tid - rp::kNP < C) out[(long long)R * C + R + tid - rp::kNP] = colsum;
}

// dx (B, D, H, W, C) from da (·, R) and w1 as (27, C, R)
__global__ void __launch_bounds__(rp::kCoreThreads, 2)
res_tile_dx_kernel(Geo g, int C, int R, const bf16* __restrict__ da, const bf16* __restrict__ w1,
                   const bf16* __restrict__ y, const bf16* __restrict__ gy, bf16* __restrict__ dx) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const rp::Origin o = rp::tile_origin(blockIdx.x, g.D, g.H, g.W);
  CoreAcc core;
  halo_core<true>(core, da, R, w1, C, g, o, smem);
  __syncthreads();
  bf16* st = reinterpret_cast<bf16*>(smem);
  core_to_tile(core, st, [&](int, int, float v0, float v1, float& o0, float& o1) {
    o0 = v0;
    o1 = v1;
  });
  __syncthreads();
  const bf16* const ins[2] = {y, gy};
  finish_tile(g, o, C, st, ins, dx, [](float (&a)[8], const uint4 (&v)[2]) {
    float yv[8], r[8];
    unpack8(v[0], yv);
    unpack8(v[1], r);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = a[i] + (yv[i] > 0.f ? r[i] : 0.f);
  });
}

// dW1 partials: part + q·27·C·R receives chunk q = blockIdx.z's Σ x(p +
// δ_t)ᵀ·da(p) as (27, C, R) for the taps of group blockIdx.x and channels
// blockIdx.y·64 …  Three warpgroups, one a tap of the group: each sums
// its 64 x 128 tile by wgmma m64n128k16, A (x shifted by the tap, m = c,
// k = voxel) from registers by ldmatrix.trans, B (da, k = voxel, n = r)
// from the staged tile by descriptor, MN-major.  The blocks of one chunk
// are neighbours in launch order, so they walk its tiles together and all
// but the first read them from L2.
__global__ void __launch_bounds__(rp::kDw1Threads, 1)
res_tile_dw1_kernel(Geo g, int C, int R, int chunk, const bf16* __restrict__ x,
                    const bf16* __restrict__ da, float* __restrict__ part) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int grp = blockIdx.x, c0 = blockIdx.y * rp::kCB, q = blockIdx.z;
  const int dz = grp / 3 - 1, dy = grp % 3 - 1;
  const int ntot = g.B * rp::tiles(g.D, g.H, g.W);
  const int t0 = q * chunk, t1 = t0 + chunk < ntot ? t0 + chunk : ntot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dxi = warp >> 2, w4 = warp & 3;  // the warpgroup's tap, the warp within it

  auto stage = [&](int tile, int slot) {
    bf16* xw = reinterpret_cast<bf16*>(smem + slot * rp::kDw1Stage);
    bf16* dt = reinterpret_cast<bf16*>(smem + slot * rp::kDw1Stage + rp::kXWinBytes);
    const rp::Origin o = rp::tile_origin(tile, g.D, g.H, g.W);
    for (int e = threadIdx.x; e < rp::kXRows * 8; e += rp::kDw1Threads) {
      const int v = e >> 3, j = e & 7;
      const int z = o.z0 + v / (rp::kTY * rp::kWX) + dz, y = o.y0 + v / rp::kWX % rp::kTY + dy,
                xx = o.x0 + v % rp::kWX - 1;
      const int c = c0 + j * 8;
      const bool ok = inside(g, z, y, xx) && c < C;
      frag::cp_async16(xw + v * rp::kCB + rp::swz(v, j) * 8,
                       ok ? x + vox(g, o.b, z, y, xx) * C + c : x, ok);
    }
    // da as two 64-channel halves of 128-byte voxel rows
    for (int e = threadIdx.x; e < rp::kTM * 16; e += rp::kDw1Threads) {
      const int p = e >> 4, j = e & 15;
      const long long v = tile_vox(g, o, p);
      const bool ok = v >= 0 && j * 8 < R;
      frag::cp_async16(dt + (j >> 3) * rp::kTM * 64 + p * 64 + rp::swz(p, j & 7) * 8,
                       ok ? da + v * R + j * 8 : da, ok);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  constexpr int kAhead = rp::kDw1Stages - 1;  // tiles in flight ahead of the one multiplied
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (t0 + i < t1) stage(t0 + i, i);
    frag::cp_commit();
  }
  for (int tile = t0, i = 0; tile < t1; ++tile, ++i) {
    frag::wg_wait<0>();  // the last tile's products are done ...
    frag::wg_fence_operand(acc);
    __syncthreads();  // ... in every warpgroup: its slot is free
    if (tile + kAhead < t1) stage(tile + kAhead, (i + kAhead) % rp::kDw1Stages);
    frag::cp_commit();
    frag::cp_wait<kAhead>();
    __syncthreads();
    const int slot = i % rp::kDw1Stages;
    const bf16* xw = reinterpret_cast<const bf16*>(smem + slot * rp::kDw1Stage);
    const unsigned char* dt = smem + slot * rp::kDw1Stage + rp::kXWinBytes;
    uint32_t a[rp::kTM / 16][4];
#pragma unroll
    for (int k = 0; k < rp::kTM / 16; ++k) {
      const int v = rp::xrow(16 * k + (lane & 7) + (lane >> 4) * 8, dxi - 1);
      frag::ldsm4_t(a[k], xw + v * rp::kCB + rp::swz(v, 2 * w4 + ((lane >> 3) & 1)) * 8);
    }
    frag::wg_fence();
#pragma unroll
    for (int k = 0; k < rp::kTM / 16; ++k)
      frag::wg_mma_rs<1>(acc, a[k],
                         frag::wg_desc_sw128(dt, k * 16 * 128, rp::kTM * 128, 8 * 128));
    frag::wg_commit();
  }
  frag::wg_wait<0>();
  frag::wg_fence_operand(acc);

  float* out = part + (long long)q * rp::part1_floats(C, R);
  const int t = rp::group_tap(grp, dxi);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 16 * w4 + (lane >> 2) + 8 * hh, r = 8 * j + 2 * (lane & 3);
      if (c < C && r < R)
        *reinterpret_cast<float2*>(out + ((long long)t * C + c) * R + r) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
}

// out[e] = Σ_q part[q·stride + e], q in increasing order
__global__ void reduce_kernel(const float* __restrict__ part, int nq, long long stride,
                              float* __restrict__ out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < stride;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < nq; ++q) s += part[q * stride + e];
    out[e] = s;
  }
}

inline int reduce(const float* part, int nq, long long stride, float* out, cudaStream_t s) {
  const long long blocks = (stride + 255) / 256;
  reduce_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(part, nq, stride, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <class K>
inline int smem_attr(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline int fwd(const Geo& g, int C, int R, const bf16* x, const bf16* w1, const bf16* b1,
               const bf16* w2, const bf16* b2, bf16* y, bf16* h, cudaStream_t s) {
  int err = smem_attr(res_tile_fwd_kernel, rp::kCoreSmem);
  if (err) return err;
  res_tile_fwd_kernel<<<rp::core_grid(g.B, g.D, g.H, g.W).x, rp::kCoreThreads, rp::kCoreSmem, s>>>(
      g, C, R, x, w1, b1, w2, b2, y, h);
  return (int)cudaGetLastError();
}

// Five launches: da with the dW2 / db partials, dx, the dW1 partials, and
// the two reductions into out = [dW1 (27, C, R) | dW2 (R, C) | db1 | db2].
inline int bwd(const Geo& g, int C, int R, const bf16* x, const bf16* h, const bf16* y,
               const bf16* gy, const bf16* w2t, const bf16* w1, bf16* dx, bf16* da, float* part,
               float* out, cudaStream_t s) {
  int err;
  if ((err = smem_attr(res_tile_da_kernel, rp::kDaSmem))) return err;
  if ((err = smem_attr(res_tile_dx_kernel, rp::kCoreSmem))) return err;
  if ((err = smem_attr(res_tile_dw1_kernel, rp::kDw1Smem))) return err;
  const long long nvox = (long long)g.B * g.D * g.H * g.W;
  const int nsub = (int)((nvox + rp::kTM - 1) / rp::kTM);
  const int n1 = rp::dw1_chunks(g.B, g.D, g.H, g.W), n2 = rp::da_chunks(g.B, g.D, g.H, g.W);
  const int ntiles = rp::core_grid(g.B, g.D, g.H, g.W).x;
  float* part2 = part + n1 * rp::part1_floats(C, R);
  res_tile_da_kernel<<<n2, rp::kThreads, rp::kDaSmem, s>>>(
      C, R, nvox, rp::chunk_len(nsub, rp::kDaChunks), y, gy, h, w2t, da, part2);
  if ((err = (int)cudaGetLastError())) return err;
  res_tile_dx_kernel<<<ntiles, rp::kCoreThreads, rp::kCoreSmem, s>>>(g, C, R, da, w1, y, gy, dx);
  if ((err = (int)cudaGetLastError())) return err;
  const rp::Grid gw = rp::dw1_grid(C, n1);
  res_tile_dw1_kernel<<<dim3(gw.x, gw.y, gw.z), rp::kDw1Threads, rp::kDw1Smem, s>>>(
      g, C, R, rp::chunk_len(ntiles, rp::kDw1Chunks), x, da, part);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = reduce(part, n1, rp::part1_floats(C, R), out, s))) return err;
  return reduce(part2, n2, rp::part2_floats(C, R), out + rp::part1_floats(C, R), s);
}

}  // namespace rt
