// Nearest-codeword search (the VQ argmin) and its EMA statistics, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of synthanatomy_tpu/ops/vq.py:
// _vq_argmin_kernel (:103, launched by nearest_codeword_pallas :122) and
// _vq_argmin_stats_kernel (:176, launched by nearest_codeword_stats_pallas
// :227).  The plain PyTorch twins are ops/vq.py (nearest_codeword_plain,
// nearest_codeword_stats_plain).
//
// x (N, D) and the codebook w (K, D) are f32.  For each row n the kernel
// returns argmin_k ‖w_k‖² − 2·x_n·w_k (the row-constant ‖x_n‖² dropped,
// as the TPU kernel drops it).  Ties go to the lower index, as jnp.argmin
// and torch.argmin break them.  Ragged N, K and D are masked in the
// kernel: padded codes get a NaN ‖w‖² and never win, padded rows are not
// written.
//
// What bounds it on this card: the products.  At the paper shape (N =
// 4200 rows at B3, K 2048, D 32) the search is 2·N·K·D ≈ 0.55 GFLOP and
// moves ~0.8 MB: 8.2 µs at the 67 TFLOP/s f32 peak, 3.3 µs for the three
// TF32 products below at the 495 TFLOP/s tensor-core peak, 0.25 µs of
// bytes.  Exact f32 FMAs cannot reach the f32 bound when each operand
// comes from shared memory (two loads an FMA: shared-memory issue sets the
// pace, ~10× the bound); mma.sync TF32 runs at about half of wgmma's rate
// on this card (one m16n8k8 every ~16 cycles a sub-partition, measured).
//
// The design (plan: vq_plan.h):
//   - The distance products run on the tensor cores at f32 grade, split
//     TF32 ("3xTF32"): each f32 operand v becomes big = tf32(v) and small
//     = tf32(v − big) (v − big is exact), and the kernel sums small·big +
//     big·small + big·big into f32 accumulators, as the TPU kernel's
//     Precision.HIGHEST is itself a multi-pass split product.  What is
//     dropped, small·small and small's rounding, is ~2^-21 of |x_d·w_d| a
//     term: ~1e-5 at D 32 on randn data, so two codes whose distances
//     differ by more than 1e-5 of the distance scale keep their order
//     (one-pass TF32 or bf16 would not: ~1e-3 a term; tests/
//     test_torch_vq_plan.py holds a numpy model of the split against JAX).
//     ‖w‖² is f32 FMAs.
//   - A block is two warpgroups on 128 rows; each warp holds its 16 rows'
//     split A fragments in registers for the whole walk (D <= 64; wider
//     rows read them again from L1 each k-step).  The products are wgmma
//     m64nNk8 .tf32 with A from registers and B from shared memory, N the
//     code tile (64: two blocks an SM, so that every cluster of the paper
//     shape fits the card at once), 3 a k-step.
//   - The codebook is split over a thread-block cluster of up to 8 blocks
//     that share the row tile (at N 4200: 33 row tiles × 4 splits of 512
//     codes = 132 blocks), so each block stages its part of the codebook
//     once for its 128 rows: 16-byte cp.async into a 2-slot raw ring while
//     the tile before is in use, then one pass splits each staged
//     codeword into K-major big and small tiles in wgmma's 128-byte
//     swizzle and sums its ‖w‖² once; the pass for tile c + 1 runs while
//     tile c's products are in flight.
//   - The argmin epilogue stays in registers: each lane keeps a running
//     (min, index) for its two rows over its columns, in increasing code
//     order (strict <: the first of equal distances stays); quad
//     shuffles, then the cluster through distributed shared memory, merge
//     with ties to the lower index.
//   - The statistics pass (vq_stats_kernel) gives each warp two
//     codewords; a block stages the indices in shared memory (4096 at a
//     time) once for its 16 codewords, each warp ballots over them in row
//     order (8 groups of 32 a step), lists the rows that chose its
//     codewords and adds them 32 rows' loads at a time: counts (K,) and Σx
//     (K, D) in f32, each codeword's rows summed in row order (the bits of
//     a plain sequential sum), with no float atomics, so two runs give
//     identical bits.  No (N, K) one-hot is formed.  nearest_codeword is
//     one cluster launch, nearest_codeword_stats two launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"
#include "vq_plan.h"

namespace {

namespace cg = cooperative_groups;
using namespace vqp;

struct Best {
  float d;
  int i;
};

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small + O(2^-22 |v|), both TF32 (v − big is exact in f32)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// d += A·B, one warpgroup's m64nNk8 product, TF32 operands, f32 sums: A
// (64 rows x 8) from registers, each warp's 16 rows in the m16n8k8 layout
// (lane (g = lane / 4, t = lane % 4): a0 (row g, k t), a1 (row g + 8, k
// t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4)); B (N codes x 8,
// K-major, 128-byte swizzle) by descriptor.  Thread (warp w of the group,
// g, t) holds rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t +
// 1 in d[4j], d[4j + 1] (row 16w + g) and d[4j + 2], d[4j + 3].
template <int N>
__device__ __forceinline__ void wg_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wg_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}
template <>
__device__ __forceinline__ void wg_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// The lane's A fragment of k-step ks, split: k slots t and t + 4 are the
// columns k_column(ks, t) and k_column(ks, t + 4) (vq_plan.h), zeros past
// N and D.
__device__ __forceinline__ void load_x(const float* __restrict__ x, int n, int d, int row, int ks,
                                       int t, uint32_t (&big)[4], uint32_t (&small)[4]) {
  const int c = k_column(ks, t), c4 = k_column(ks, t + 4);
  float v[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g, g + 8
    const int r = row + 8 * h;
    const float* xr = x + (int64_t)r * d;
    v[h] = r < n && c < d ? __ldg(xr + c) : 0.f;
    v[h + 2] = r < n && c4 < d ? __ldg(xr + c4) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], big[e], small[e]);
}

// Grid (splits × row tiles), clusters of the splits of a row tile.  KS:
// the k-steps of x held in registers (vq_plan.h reg_steps: 4 or 8), 0 for
// rows wider than 64; NT: the code tile, the products' N.  Rows up to 32
// wide at a tile of 64 take at most 128 registers: two blocks an SM.
template <int KS, int NT>
__global__ void __launch_bounds__(kThreads, KS == 4 && NT <= 64 ? 2 : 1)
vq_argmin_kernel(const float* __restrict__ x, const float* __restrict__ w, int n, int k, int d,
                 int* __restrict__ idx) {
  extern __shared__ __align__(1024) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = splits(n, k), rank = (int)cluster.block_rank();
  // the sizes of the plan: compile-time for rows up to 64 wide (KS > 0)
  const int dp = KS ? 8 * KS : padded_d(d), kst = dp / 8, rrow = dp + 4;
  const int tile = NT * 4 * dp;                              // one split tile
  uint8_t* spl = smem;                                       // [2][big, small][tile]
  float* raw = reinterpret_cast<float*>(smem + 4 * tile);    // [2][NT][rrow]
  float* wsq = raw + 2 * NT * rrow;                          // [2][NT]
  Best* mrg = reinterpret_cast<Best*>(wsq + 2 * NT);         // [kRows]

  const int c0 = split_begin(n, k, rank), c1 = split_end(n, k, rank);
  const int tiles = ceil_div(c1 - c0, NT);
  const int r0 = (blockIdx.x / S) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int row = r0 + 16 * warp + g;
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  // tile c of the split into raw slot c % 2 (one commit group a call,
  // empty past the last tile); codes past the split and columns past D
  // are zeros
  auto stage = [&](int c) {
    if (c < tiles) {
      float* dst = raw + (c & 1) * NT * rrow;
      const int code0 = c0 + c * NT;
      if (vec) {
        const int per = dp / 4;
        for (int e = tid; e < NT * per; e += kThreads) {
          const int cc = e / per, dd = 4 * (e % per), code = code0 + cc;
          const bool ok = code < c1 && dd < d;
          frag::cp_async16(dst + cc * rrow + dd, ok ? w + (int64_t)code * d + dd : w, ok);
        }
      } else {
        for (int e = tid; e < NT * dp; e += kThreads) {
          const int cc = e / dp, dd = e % dp, code = code0 + cc;
          const bool ok = code < c1 && dd < d;
          frag::cp_async4(dst + cc * rrow + dd, ok ? w + (int64_t)code * d + dd : w, ok);
        }
      }
    }
    frag::cp_commit();
  };

  // raw slot c % 2 → the big and small tiles of split slot c % 2, and ‖w‖²
  // by f32 FMAs (NaN past the split: those codes never win), in one pass:
  // item (code, k-step), kst neighbouring threads a code
  auto split_tile = [&](int c) {
    uint8_t* big = spl + (c & 1) * 2 * tile;
    uint8_t* small = big + tile;
    // items a thread: at most NT·32 / kThreads (D 256), a constant for KS > 0
    const int items = split_items(KS ? 8 * KS : d) / kThreads;
#pragma unroll
    for (int u = 0; u < NT * (KS ? KS : 32) / kThreads; ++u) {
      if (u >= items) break;
      const int i = tid + kThreads * u, cc = i / kst, ks = i % kst;
      const float* src = raw + (c & 1) * NT * rrow + cc * rrow + 8 * ks;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t b[8], sm[8];
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        split_tf32(v[e], b[e], sm[e]);
        s = fmaf(v[e], v[e], s);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // chunk h: k slots 4h to 4h + 3
        const int o = split_offset(NT, cc, ks, h);
        *reinterpret_cast<uint4*>(big + o) =
            make_uint4(b[k_column(0, 4 * h)], b[k_column(0, 4 * h + 1)],
                       b[k_column(0, 4 * h + 2)], b[k_column(0, 4 * h + 3)]);
        *reinterpret_cast<uint4*>(small + o) =
            make_uint4(sm[k_column(0, 4 * h)], sm[k_column(0, 4 * h + 1)],
                       sm[k_column(0, 4 * h + 2)], sm[k_column(0, 4 * h + 3)]);
      }
      for (int o = kst / 2; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (ks == 0)
        wsq[(c & 1) * NT + cc] = c0 + c * NT + cc < c1 ? s : __int_as_float(0x7fc00000);
    }
    // the generic proxy's writes become visible to the products' (async) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  stage(0);
  stage(1);

  uint32_t xb[KS > 0 ? KS : 1][4], xs[KS > 0 ? KS : 1][4];
  if constexpr (KS > 0) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_x(x, n, d, row, ks, t, xb[ks], xs[ks]);
  }
  float bd[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};  // rows g, g + 8
  int bi[2] = {0x7fffffff, 0x7fffffff};

  // the warpgroup's products against the codes of split slot c % 2: for
  // each k-step small·big, big·small, big·big into the f32 sums (while
  // they run, the block splits tile c + 1 into the other slot), then the
  // argmin epilogue on the lane's columns in code order
  auto products = [&](int c) {
    const bool next = c + 1 < tiles;
    const uint8_t* big = spl + (c & 1) * 2 * tile;
    const uint8_t* small = big + tile;
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    auto desc = [&](const uint8_t* t0, int ks) {
      return frag::wg_desc_sw128(t0, (ks / 4) * NT * kAtom + (ks % 4) * 32, 16, 1024);
    };
    frag::wg_fence_operand(acc);
    if constexpr (KS > 0) {
      frag::wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wg_tf32<NT>(acc, xs[ks], desc(big, ks));
        wg_tf32<NT>(acc, xb[ks], desc(small, ks));
        wg_tf32<NT>(acc, xb[ks], desc(big, ks));
      }
      frag::wg_commit();
      if (next) split_tile(c + 1);
      frag::wg_wait<0>();
    } else {
      for (int ks = 0; ks < kst; ++ks) {  // x's fragments of this k-step, from L1
        uint32_t ab[4], as[4];
        load_x(x, n, d, row, ks, t, ab, as);
        frag::wg_fence();
        wg_tf32<NT>(acc, as, desc(big, ks));
        wg_tf32<NT>(acc, ab, desc(small, ks));
        wg_tf32<NT>(acc, ab, desc(big, ks));
        frag::wg_commit();
        frag::wg_wait<0>();
      }
      if (next) split_tile(c + 1);
    }
    frag::wg_fence_operand(acc);
    const float* ws = wsq + (c & 1) * NT + 2 * t;
    const int code0 = c0 + c * NT;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const float2 wq = *reinterpret_cast<const float2*>(ws + 8 * j);
      const int code = code0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = fmaf(-2.f, acc[4 * j + 2 * h], wq.x);
        const float d1 = fmaf(-2.f, acc[4 * j + 2 * h + 1], wq.y);
        if (d0 < bd[h]) {
          bd[h] = d0;
          bi[h] = code;
        }
        if (d1 < bd[h]) {
          bd[h] = d1;
          bi[h] = code + 1;
        }
      }
    }
  };

  frag::cp_wait<1>();  // tile 0 landed (this thread's copies)
  __syncthreads();
  split_tile(0);
  for (int c = 0; c < tiles; ++c) {
    frag::cp_wait<0>();  // tile c + 1 landed
    // tile c + 1's raw rows and tile c's split tiles are visible; every
    // warp is done with raw slot c % 2 (tile c) and split slot (c + 1) % 2
    __syncthreads();
    stage(c + 2);
    products(c);  // and the split of tile c + 1
  }

  // the row's best over the quad's columns, then over the cluster
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o *= 2) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[h], o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[h], o);
      if (better(od, oi, bd[h], bi[h])) {
        bd[h] = od;
        bi[h] = oi;
      }
    }
    if (t == 0) mrg[16 * warp + g + 8 * h] = Best{bd[h], bi[h]};
  }
  cluster.sync();
  const int i = merge_row(n, k, rank, tid);  // rank r writes rows r, r + S, ... of the tile
  if (tid < merge_rows(n, k, rank) && r0 + i < n) {
    Best b = *cluster.map_shared_rank(&mrg[i], 0);
    for (int s = 1; s < S; ++s) {
      const Best o = *cluster.map_shared_rank(&mrg[i], s);
      if (better(o.d, o.i, b.d, b.i)) b = o;
    }
    idx[r0 + i] = b.i == 0x7fffffff ? 0 : b.i;  // no code won (NaN rows): 0
  }
  cluster.sync();  // every rank has read the others' rows before any exits
}

__global__ void __launch_bounds__(kStatWarps * 32)
vq_stats_kernel(const float* __restrict__ x, const int* __restrict__ idx, int n, int k, int d,
                float* __restrict__ counts, float* __restrict__ dw) {
  __shared__ __align__(16) int sidx[kIdxChunk];
  __shared__ int rows[kStatWarps][kStatCodesPerWarp][kStatList];
  __shared__ float sums[kStatWarps][kStatCodesPerWarp][kMaxD];  // Σx, a codeword a row
  static_assert(sizeof(sidx) + sizeof(rows) + sizeof(sums) == kStatSmem, "vq_plan.h kStatSmem");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int code0 = blockIdx.x * kStatCodes + warp * kStatCodesPerWarp;
  for (int e = lane; e < kStatCodesPerWarp * kMaxD; e += 32) (&sums[warp][0][0])[e] = 0.f;
  int count[kStatCodesPerWarp] = {}, len[kStatCodesPerWarp] = {};
  // add the listed rows of codeword q in row order, kStatBatch rows at a
  // time: each lane takes one row number, the warp's loads of those rows
  // (a lane a column) issue together, then the adds in row order into the
  // column's running sum (adding the zeros of a short batch leaves every
  // sum's bits as they are)
  auto flush = [&](int q) {
    const int* list = rows[warp][q];
    for (int i = 0; i < len[q]; i += kStatBatch) {
      const int m = imin(kStatBatch, len[q] - i);
      const int mine = list[i + (lane < m ? lane : 0)];
      for (int d0 = 0; d0 < d; d0 += 32) {  // every lane, so that the shuffles see all
        const int dd = d0 + lane;
        float v[kStatBatch];
#pragma unroll
        for (int b = 0; b < kStatBatch; ++b) {
          const int r = __shfl_sync(0xffffffffu, mine, b);
          v[b] = b < m && dd < d ? __ldg(x + (int64_t)r * d + dd) : 0.f;
        }
        if (dd < d) {
          float acc = sums[warp][q][dd];
#pragma unroll
          for (int b = 0; b < kStatBatch; ++b) acc += v[b];
          sums[warp][q][dd] = acc;
        }
      }
    }
    __syncwarp();  // every lane has read the list before it is refilled
    len[q] = 0;
  };
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  for (int chunk = 0; chunk < idx_chunks(n); ++chunk) {
    const int base = chunk * kIdxChunk, clen = imin(kIdxChunk, n - base);
    __syncthreads();  // every warp is done with the previous chunk
    if (vec && base % 4 == 0) {
      const int4* src = reinterpret_cast<const int4*>(idx + base);
#pragma unroll 4
      for (int e = tid; e < clen / 4; e += kStatWarps * 32) reinterpret_cast<int4*>(sidx)[e] = __ldg(src + e);
      for (int e = clen / 4 * 4 + tid; e < clen; e += kStatWarps * 32) sidx[e] = __ldg(idx + base + e);
    } else {
      for (int e = tid; e < clen; e += kStatWarps * 32) sidx[e] = __ldg(idx + base + e);
    }
    __syncthreads();
    // kStatScan groups of 32 rows a step: one ballot a group for the
    // warp's codewords, the rows listed only where a group holds one
    for (int r0 = 0; r0 < clen; r0 += 32 * kStatScan) {
      int v[kStatScan];
      unsigned any[kStatScan], some = 0;
#pragma unroll
      for (int u = 0; u < kStatScan; ++u) {
        const int r = r0 + 32 * u + lane;
        v[u] = r < clen ? sidx[r] : -1;
        any[u] = __ballot_sync(0xffffffffu, v[u] >= code0 && v[u] < code0 + kStatCodesPerWarp);
        some |= any[u];
      }
      if (!some) continue;
#pragma unroll
      for (int u = 0; u < kStatScan; ++u) {
        if (!any[u]) continue;
#pragma unroll
        for (int q = 0; q < kStatCodesPerWarp; ++q) {
          const unsigned hit = __ballot_sync(0xffffffffu, v[u] == code0 + q);
          if (!hit) continue;  // list the rows that chose this codeword, in row order
          if (v[u] == code0 + q)
            rows[warp][q][len[q] + __popc(hit & ((1u << lane) - 1))] = base + r0 + 32 * u + lane;
          len[q] += __popc(hit);
          count[q] += __popc(hit);
          __syncwarp();
          if (len[q] > kStatList - 32) flush(q);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kStatCodesPerWarp; ++q) {
    flush(q);
    const int code = code0 + q;
    if (code >= k) continue;
    if (lane == 0) counts[code] = (float)count[q];
    for (int dd = lane; dd < d; dd += 32) dw[(int64_t)code * d + dd] = sums[warp][q][dd];
  }
}

// The launch of an (n, k, d) search: its grid, a cluster of the splits of
// a row tile, and its shared memory, after the opt-in above 48 KB (once
// per instantiation).  clusters: instead of launching, ask how many such
// clusters the card holds at once.
template <int KS, int NT>
cudaError_t launch_ks(int n, int k, int d, const float* x, const float* w, int* idx,
                      cudaStream_t s, int* clusters) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      vq_argmin_kernel<KS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (allowed != cudaSuccess) return allowed;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits(n, k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(argmin_blocks(n, k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = argmin_smem(d);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) return cudaOccupancyMaxActiveClusters(clusters, vq_argmin_kernel<KS, NT>, &cfg);
  return cudaLaunchKernelEx(&cfg, vq_argmin_kernel<KS, NT>, x, w, n, k, d, idx);
}

// the instantiation of each padded width: 32 and 64 with x in registers
int launch_argmin(int n, int k, int d, const float* x, const float* w, int* idx, cudaStream_t s,
                  int* clusters = nullptr) {
  if (n < 1 || k < 1 || !width_ok(d)) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  switch (padded_d(d)) {
    case 32: e = launch_ks<4, code_tile(32)>(n, k, d, x, w, idx, s, clusters); break;
    case 64: e = launch_ks<8, code_tile(64)>(n, k, d, x, w, idx, s, clusters); break;
    case 128: e = launch_ks<0, code_tile(128)>(n, k, d, x, w, idx, s, clusters); break;
    default: e = launch_ks<0, code_tile(256)>(n, k, d, x, w, idx, s, clusters); break;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan's numbers (vq_plan.h): the widest row the kernels take, an
// argmin block's dynamic shared memory for rows of width d, its blocks
// and cluster size for (n, k), and how many of those clusters the card
// holds at once (cudaOccupancyMaxActiveClusters).
int vq_max_d() { return kMaxD; }
long long vq_smem_bytes(int d) { return width_ok(d) ? argmin_smem(d) : -1; }
int vq_blocks(int n, int k) { return argmin_blocks(n, k); }
int vq_cluster(int n, int k) { return splits(n, k); }
int vq_active_clusters(int n, int k, int d) {
  int clusters = -1;
  const int e = launch_argmin(n, k, d, nullptr, nullptr, nullptr, nullptr, &clusters);
  return e ? -e : clusters;
}

// One (cluster) launch.  Returns a cudaError_t.
int vq_argmin(int n, int k, int d, const void* x, const void* w, void* idx, void* stream) {
  return launch_argmin(n, k, d, static_cast<const float*>(x), static_cast<const float*>(w),
                       static_cast<int*>(idx), static_cast<cudaStream_t>(stream));
}

// Two launches: the argmin, then the per-codeword statistics.
int vq_argmin_stats(int n, int k, int d, const void* x, const void* w, void* idx,
                    void* counts, void* dw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  int err = launch_argmin(n, k, d, xf, static_cast<const float*>(w), static_cast<int*>(idx), s);
  if (err) return err;
  vq_stats_kernel<<<stat_blocks(k), kStatWarps * 32, 0, s>>>(
      xf, static_cast<const int*>(idx), n, k, d, static_cast<float*>(counts),
      static_cast<float*>(dw));
  return (int)cudaGetLastError();
}

}  // extern "C"
