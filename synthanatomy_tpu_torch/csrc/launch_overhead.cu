// The tile program of the launch-overhead probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/probe_pallas_overhead.py: _kernel
// (:48), launched by _call (:63, pallas_call :64) over a grid of G steps
// that each add x · w into one f32 accumulator and write bf16(acc) at the
// end; x (M, K) and w (K, N) bf16 (256 × 512 and 512 × 512 in the probe),
// the same blocks at every step.  The plain twin is
// ops/probes.py::tile_steps_plain.
//
// What bounds it: operations, 2·M·K·N a step (134 MFLOP at the probe's
// shape, 0.136 µs at 989 TFLOP/s).  The probe reads what a launch costs
// beside that, so the kernel's own fixed cost has to be small against a
// launch, and a step has to run near the tensor cores' rate.
//
// What the design does about it (the plan is overhead_plan.h):
//   - The card is filled: each 64 × 64 output tile's contraction is split
//     over a thread-block cluster, as many splits as fill the SMs once and
//     only where every cluster of the grid is resident at once, one block
//     an SM (cudaOccupancyMaxActiveClusters, asked once per cluster size).
//     A block asks for 116 KB of shared memory so that it has its SM
//     alone: clusters fill whole GPCs, only 30 clusters of 4 find an SM
//     each, and two blocks on one SM halve the step of the whole grid.  At
//     the probe's shape: 32 tiles × 3 splits of 11 k16 products = 96
//     blocks.
//   - The G steps stay sequential inside every block, as the TPU's grid
//     steps: the f32 sums live in registers from the first step to the
//     last, and each step is the split's k16 products on wgmma m64n64k16
//     (bf16, f32 sums), A (x) from registers, B (w) from shared memory by
//     descriptor, MN-major.  x's fragments are read from shared memory
//     once (ldmatrix) and kept for every step; one step's products run
//     while the next step's are issued.
//   - The prologue is one tile copy a block: x's and w's slices by 16-byte
//     cp.async straight into wgmma's 128-byte swizzle (w as it lies, N
//     contiguous: the descriptor's MN-major mode takes the place of a
//     transpose), zeros past K.
//   - The epilogue: each split pushes its sums of every 8-column group into
//     the shared memory of the group's owner rank (distributed shared
//     memory stores, no round trip), one cluster barrier, then each owner
//     adds its groups' sums in rank order (two runs are bit-identical),
//     rounds once and writes them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"
#include "overhead_plan.h"

namespace cg = cooperative_groups;

namespace {

using namespace ovp;

// Grid blocks(M, N, S), clusters of S: block b is split b % S (its rank)
// of tile b / S.  P: the products of a split (split_products(K, S)).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
tile_steps_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  int K, int N, int S, int steps, __nv_bfloat16* __restrict__ out) {
  static_assert(P >= 1 && P <= kMaxProducts, "products of a split");
  static_assert(kThreads == 2 * kTile && kThreads == 8 * kDepth, "the staging's thread map");
  static_assert(needed_smem(P, 7) <= kOneBlockSmem,  // S 7: the largest buffer of sums
                "the slices and the sums fit the block's shared memory");
  extern __shared__ __align__(1024) uint8_t smem[];
  frag::cluster_arrive();  // this block has started: the others may push into it
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), tile = blockIdx.x / S, nt = N / kTile;
  const int i0 = (tile / nt) * kTile, j0 = (tile % nt) * kTile, k0 = split_k0(K, S, rank);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  uint8_t* xs = smem;
  uint8_t* ws = xs + x_tile_bytes(P);
  uint8_t* sums = ws + w_tile_bytes(P);

  // the slices, 16 bytes a copy, zeros past K: x's 64 rows of 16P k (2P
  // chunks a row; a thread takes every other chunk of one row), w's 16P
  // rows of 64 columns (8 chunks a row; a thread takes one chunk of every
  // 16th row)
  {
    const int r = tid / 2, h = tid % 2;
    const __nv_bfloat16* src = x + (int64_t)(i0 + r) * K + k0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k = 8 * (2 * i + h);
      const bool ok = k0 + k < K;
      frag::cp_async16(xs + x_offset(r, k), ok ? src + k : x, ok);
    }
  }
  {
    const int c = tid % 8, kr = tid / 8;
    const __nv_bfloat16* src = w + (int64_t)(k0 + kr) * N + j0 + 8 * c;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k = kDepth * i + kr;
      const bool ok = k0 + k < K;
      frag::cp_async16(ws + w_offset(k, c), ok ? src + (int64_t)kDepth * i * N : w, ok);
    }
  }
  frag::cp_commit();
  frag::cp_wait<0>();
  // the copies become visible to the products' (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // x's A fragments, the warp's 16 rows, for every step: lanes 0-15 point
  // at rows 0-15 of k 16p, lanes 16-31 at the same rows of k 16p + 8
  uint32_t a[P][4];
#pragma unroll
  for (int p = 0; p < P; ++p)
    frag::ldsm4(a[p], xs + x_offset(16 * warp + lane % 16, 16 * p + 8 * (lane / 16)));
  const uint64_t desc0 = frag::wg_desc_sw128(ws, 0, w_tile_bytes(P), kSbo);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  frag::wg_fence_operand(acc);
  for (int s = 0; s < steps; ++s) {
    frag::wg_fence();
#pragma unroll
    for (int p = 0; p < P; ++p)  // the descriptor's start, in 16-byte units
      frag::wg_mma_rs64<1>(acc, a[p], desc0 + (w_product_offset(p) >> 4));
    frag::wg_commit();
    frag::wg_wait<1>();  // the step before is done; this one runs on
    frag::wg_fence_operand(acc);
  }
  frag::wg_wait<0>();
  frag::wg_fence_operand(acc);

  // the split's sums (thread: rows 16·warp + g and + 8, columns 8j + 2t and
  // + 1) into the buffer of each group's owner (j % S), at this rank's slot
  // for the group (slot j / S)
  const int g = lane / 4, t = lane % 4, per_rank = owned(S, 0) * kGroupBytes;
  frag::cluster_wait();  // every block of the cluster has started
  int owner = 0, slot = 0;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* dst = reinterpret_cast<float2*>(
          sums + sums_offset(S, rank, slot, 16 * warp + g + 8 * h) + 8 * t);
      *cluster.map_shared_rank(dst, owner) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    if (++owner == S) {
      owner = 0;
      ++slot;
    }
  }
  cluster.sync();  // every split's sums have landed; no block reads another's memory after
  // the owned groups, 4 columns a thread at a time: the ranks' sums in
  // rank order, rounded once
  for (int i = tid; i < owned(S, rank) * kTile * 2; i += kThreads) {
    const int u = i / (2 * kTile), row = (i / 2) % kTile, half = i % 2;
    const uint8_t* src = sums + sums_offset(S, 0, u, row) + 16 * half;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(src + q * per_rank);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int col = 8 * group(S, rank, u) + 4 * half;
    *reinterpret_cast<uint2*>(out + (int64_t)(i0 + row) * N + j0 + col) =
        make_uint2(frag::pack(sum.x, sum.y), frag::pack(sum.z, sum.w));
  }
}

// nothing: the floor of a launch of a given geometry
__global__ void empty_kernel() {}

// The launch of a (P products a split) program, or with `clusters`, how
// many of its clusters the card holds at once; after the shared-memory
// opt-in (once per instantiation), without which the query reads 0.
template <int P>
cudaError_t launch_p(int blocks, int S, const __nv_bfloat16* x, const __nv_bfloat16* w, int K,
                     int N, int steps, __nv_bfloat16* out, cudaStream_t s, int* clusters) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      tile_steps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kOneBlockSmem);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kOneBlockSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, tile_steps_kernel<P>, &cfg);
  return cudaLaunchKernelEx(&cfg, tile_steps_kernel<P>, x, w, K, N, S, steps, out);
}

cudaError_t launch(int P, int blocks, int S, const __nv_bfloat16* x, const __nv_bfloat16* w,
                   int K, int N, int steps, __nv_bfloat16* out, cudaStream_t s,
                   int* clusters = nullptr) {
  switch (P) {
    case 1: return launch_p<1>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 2: return launch_p<2>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 3: return launch_p<3>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 4: return launch_p<4>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 5: return launch_p<5>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 6: return launch_p<6>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 7: return launch_p<7>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 8: return launch_p<8>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 9: return launch_p<9>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 10: return launch_p<10>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 11: return launch_p<11>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 12: return launch_p<12>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 13: return launch_p<13>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 14: return launch_p<14>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 15: return launch_p<15>(blocks, S, x, w, K, N, steps, out, s, clusters);
    case 16: return launch_p<16>(blocks, S, x, w, K, N, steps, out, s, clusters);
    default: return cudaErrorInvalidValue;
  }
}

// clusters of S blocks of P products that the card holds at once (one
// block an SM), asked once per (S, P); 0 where the query fails
int fit(int S, int P) {
  static int known[kMaxCluster + 1][kMaxProducts + 1];  // the count + 1; 0: not asked yet
  if (!known[S][P]) {
    int n = 0;
    if (launch(P, S, S, nullptr, nullptr, 0, kTile, 0, nullptr, nullptr, &n) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    known[S][P] = n + 1;
  }
  return known[S][P] - 1;
}

struct Plan {
  int blocks, S, P;
};

Plan plan(int M, int K, int N) {
  const int S = splits(M, K, N, fit);
  return {blocks(M, N, S), S, split_products(K, S)};
}

}  // namespace

extern "C" {

// The largest K the kernel takes (M and N multiples of 64, K of 16).
int launch_overhead_max_k() { return kMaxK; }

// The plan of an (M, K, N) program into out[0..5]: blocks, threads a
// block, cluster size (the splits of K), k16 products a split, dynamic
// shared memory (bytes), and how many such clusters the card holds at
// once.  Returns 0, or -1 for a shape the kernel does not take.
int launch_overhead_plan(int M, int K, int N, int* out) {
  if (!shape_ok(M, K, N)) return -1;
  const Plan p = plan(M, K, N);
  const int v[6] = {p.blocks, kThreads, p.S, p.P, kOneBlockSmem, fit(p.S, p.P)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// out (M, N) bf16 = bf16(Σ_{steps} x · w), f32 accumulation; x (M, K), w
// (K, N) bf16.  One (cluster) launch; returns a cudaError_t.
int launch_overhead(int M, int K, int N, int steps, const void* x, const void* w, void* out,
                    void* stream) {
  if (!shape_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, K, N);
  const cudaError_t e =
      launch(p.P, p.blocks, p.S, static_cast<const __nv_bfloat16*>(x),
             static_cast<const __nv_bfloat16*>(w), K, N, steps, static_cast<__nv_bfloat16*>(out),
             static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// One launch of an empty kernel: `blocks` blocks of `threads`, in clusters
// of `cluster`, with `smem` bytes of dynamic shared memory (the floor of a
// kernel of that geometry, for the probes).  Returns a cudaError_t.
int launch_empty(int blocks, int threads, int cluster, int smem, void* stream) {
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
