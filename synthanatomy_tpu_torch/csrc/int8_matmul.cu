// Weight-only quantized GEMV for Hopper (sm_90a): x (R, K) f32 times
// int8 weights (K, N) with a per-channel f32 scale, and the packed-int4
// product the int4 probes run.
//
// Replaces the TPU kernel of synthanatomy_tpu/ops/quant.py: _kernel
// (:103), launched by _int8_matmul_pallas (:112, pallas_call :119) under
// int8_matmul (:139): out = (bf16(x) · bf16(w_q)) accumulated in f32,
// THEN × scale, as the Pallas body applies it.  The plain PyTorch twin is
// ops/quant.py::int8_matmul_plain.  The packed product (int4_matmul) is
// the body of tools/probe_int4_unpack.py's E (kernel_dot :79) and F
// (kernel_grid :107): weights (L, K/2, N) nibble-packed along K, out =
// (x_lo · lo) × s[0] + (x_hi · hi) × s[1]; with L > 1 one launch walks the
// L layer blocks in order and the output is the last layer's product, as
// the TPU grid's constant output block leaves it.  Twin:
// ops/quant.py::int4_matmul_plain.
//
// On the tensor cores (weight_gemv.cuh): a block is one warp on a strip
// of 32 columns, the x rows of its row group (up to 64) as the mma's M
// and one split of K (gemv_plan.h: the least power of two of splits that
// gives 132 blocks, at most 16).  The splits of a strip are one
// thread-block cluster: each keeps its unscaled f32 sums in shared memory,
// and the block of split y adds rows y, y + S, ... of every split's sums
// through distributed shared memory in split order, then applies the
// scale (one per half for int4) and stores f32.  No atomics: two runs
// give identical bits.  Any R, K and N: rows past R and columns past N
// are zeros; 16-byte weight copies where N % 16 == 0 and the weights are
// aligned, byte loads otherwise.
//
// What bounds it: the weights, read once for up to 64 rows of x: K·N
// bytes (+ 4·(R·K + R·N + N)); at the paper decode shapes (R 16, K×N
// 512×2048) about 1.2 MB, 0.36 µs at 3.35 TB/s, below a launch's own
// cost: the kernel is launch-bound, and its 256 blocks of one warp put
// every weight copy in flight at once.

#include <cooperative_groups.h>

#include "weight_gemv.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sa_gemv;

// Grid (strips of N, splits of K, row groups), clusters of the splits.
// Shared memory: the warp's ring, x's piece, the split's sums (NACC
// halves of 16·MT x 32 f32).
template <int FMT, int MT, bool VEC>
__global__ void __launch_bounds__(32)
matmul_kernel(const float* __restrict__ x, int R, int K, const int8_t* __restrict__ w,
              const float* __restrict__ scale, int N, int layers, int vec_x,
              float* __restrict__ out) {
  constexpr int NACC = FMT == kInt4 ? 2 : 1, NH = NACC;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int Kp = packed_rows(K, FMT), strip = blockIdx.x, z = blockIdx.z;
  const int S = gridDim.y, y = (int)cluster.block_rank();
  const int k0 = split_begin(Kp, N, R, blockIdx.y), k1 = k0 + split_count(Kp, N, R, blockIdx.y);
  const int row0 = 16 * MT * z, n0 = kStrip * strip, lane = lane_id();
  const int xrows = matmul_x_rows(Kp, N, R, FMT);
  const int ldx = x_row(xrows), xhalf = 16 * MT * ldx;
  const Ring<1> ring{smem, lane, 0};
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + ring_bytes(1));
  float* tile = reinterpret_cast<float*>(smem + ring_bytes(1) + x_bytes(MT, xrows, FMT));
  const int pieces = (k1 - k0 + piece_rows(FMT) - 1) / piece_rows(FMT);
  const long long layer_w = (long long)Kp * N;
  const int layer_s = NH * N;

  for (int l = 0; l < layers; ++l) {
    float acc[NACC][MT][4][4];
    zero(acc);
    const Strip st{w + l * layer_w + n0, N, min(kStrip, N - n0)};
    for (int p0 = k0; p0 < k1; p0 += piece_rows(FMT)) {
      const int p1 = min(k1, p0 + piece_rows(FMT));
      ring_begin<1, VEC>(st, p0, p1, ring);  // weights in flight while x is staged
      if (l == 0 || pieces > 1) {  // x does not depend on the layer
        __syncwarp();  // the warp is done with the piece before
        stage_x<8>(x, K, R, row0, 16 * MT, Kp, NH, p0, p1, xs, ldx, xhalf, vec_x, lane, 32);
        __syncwarp();
      }
      strip_product<FMT, MT, NACC, 1, VEC>(st, p0, p1, xs, ldx, xhalf, ring, 0, acc);
    }
#pragma unroll
    for (int a = 0; a < NACC; ++a)
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            tile[(a * 16 * MT + acc_row(t, r)) * kStrip + acc_col(j, r)] = acc[a][t][j][r];
    // the lane's column scales, loaded before the cluster barrier
    const int col = n0 + lane;
    const float* s = scale + (long long)l * layer_s;
    const float s0 = col < N ? s[col] : 0.f, s1 = NACC == 2 && col < N ? s[N + col] : 0.f;
    cluster.sync();
    // split y: rows y, y + S, ... of the strip, a lane a column; every
    // split's sum read at once, then added in split order
    for (int row = y; row < 16 * MT; row += S) {
      const int b = row0 + row;
      if (b >= R) break;
      float v[NACC][kMaxSplits];
#pragma unroll
      for (int a = 0; a < NACC; ++a)
#pragma unroll
        for (int zz = 0; zz < kMaxSplits; ++zz)
          if (zz < S)
            v[a][zz] = *cluster.map_shared_rank(&tile[(a * 16 * MT + row) * kStrip + lane], zz);
      float o = 0.f;
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        float sum = 0.f;
#pragma unroll
        for (int zz = 0; zz < kMaxSplits; ++zz)
          if (zz < S) sum += v[a][zz];
        o += sum * (a == 0 ? s0 : s1);
      }
      if (col < N) out[(long long)b * N + col] = o;
    }
    cluster.sync();  // every split has read the tiles before they change or exit
  }
}

template <int FMT, int MT, bool VEC>
cudaError_t launch_mt(int R, int K, int N, int layers, const float* x, const int8_t* w,
                      const float* scale, float* out, int vec_x, cudaStream_t st) {
  static cudaError_t allowed = allow(matmul_kernel<FMT, MT, VEC>, true);
  if (allowed != cudaSuccess) return allowed;
  const int Kp = packed_rows(K, FMT);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits(Kp, N, R);
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips(N), splits(Kp, N, R), row_groups(R));
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = matmul_smem(Kp, N, R, FMT);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, matmul_kernel<FMT, MT, VEC>, x, R, K, w, scale, N, layers,
                            vec_x, out);
}

template <int FMT>
int launch(int R, int K, int N, int layers, const void* x, const void* w, const void* scale,
           void* out, int vec, int vec_x, cudaStream_t s) {
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  const int mt = m_tiles(R);
  cudaError_t e;
  if (mt == 1)
    e = vec ? launch_mt<FMT, 1, true>(R, K, N, layers, xf, wq, sf, of, vec_x, s)
            : launch_mt<FMT, 1, false>(R, K, N, layers, xf, wq, sf, of, vec_x, s);
  else if (mt == 2)
    e = vec ? launch_mt<FMT, 2, true>(R, K, N, layers, xf, wq, sf, of, vec_x, s)
            : launch_mt<FMT, 2, false>(R, K, N, layers, xf, wq, sf, of, vec_x, s);
  else
    e = vec ? launch_mt<FMT, kMaxTiles, true>(R, K, N, layers, xf, wq, sf, of, vec_x, s)
            : launch_mt<FMT, kMaxTiles, false>(R, K, N, layers, xf, wq, sf, of, vec_x, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan's numbers of a launch (gemv_plan.h): its blocks and each
// block's dynamic shared memory.
int gemv_matmul_blocks(int R, int K, int N, int int4) {
  return matmul_blocks(packed_rows(K, int4), N, R);
}
int gemv_matmul_smem(int R, int K, int N, int int4) {
  return matmul_smem(packed_rows(K, int4), N, R, int4);
}

// out (R, N) f32 = (bf16(x) · w_q) × scale; x (R, K) f32, w_q (K, N)
// int8, scale (N,) f32.  vec: N % 16 == 0 and w_q 16-byte aligned; vec_x:
// K % 16 == 0 and x 16-byte aligned.  Returns a cudaError_t.
int int8_matmul(int R, int K, int N, const void* x, const void* w, const void* scale,
                void* out, int vec, int vec_x, void* stream) {
  return launch<kInt8>(R, K, N, 1, x, w, scale, out, vec, vec_x,
                       static_cast<cudaStream_t>(stream));
}

// out (R, N) f32 = (bf16(x_lo) · lo) × s[0] + (bf16(x_hi) · hi) × s[1] of
// the last of `layers` layer blocks; w (layers, K/2, N) packed int8,
// scale (layers, 2, N) f32.
int int4_matmul(int R, int K, int N, int layers, const void* x, const void* w,
                const void* scale, void* out, int vec, int vec_x, void* stream) {
  return launch<kInt4>(R, K, N, layers, x, w, scale, out, vec, vec_x,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
