// The L-layer weight-stream chain of the int4 probe, for Hopper (sm_90a).
//
// Replaces the TPU kernels of tools/probe_int4.py: make().kernel (:49,
// pallas_call :69; int8 and jnp.int4 weights) and make_packed().kernel
// (:108, pallas_call :131; nibble-packed int4).  Over a grid of L layers
// the TPU kernel adds into one VMEM accumulator
//
//     acc += fold(bf16(x) · W_i · s_i) · 1e-3,   fold: (B, N) → (B, K),
//     summing y.reshape(B, N/K, K) over its middle axis,
//
// with x (B, K) bf16, W (L, K, N) int8 or packed (L, K/2, N), s (L, 1, N)
// f32 (the packed form scales lo + hi by the one s_i).  The plain twin is
// ops/probes.py::weight_stream_plain.  On this card jnp.int4 has
// no tensor type of its own: its nibble-packed layout is the packed form.
//
// Blocks run in parallel here, so the sequential layer grid becomes a
// grid of (128 output columns c0, layer i, row group): the block's warps
// take the strips g·K + c0 + 32h, h < 4, of every fold group g
// (gemv_plan.h: up to 8 warps, in rounds of whole groups), each on the
// tensor-core core of weight_gemv.cuh with the block's rows of x (up to
// 64) staged once as bf16; a group's four warps share one cp.async ring
// of its rows, 128 bytes of a row a line; the packed form adds lo and hi
// into one sum.  The warps scale their sums
// by s_i and fold them into shared memory in g order, and the block
// writes one partial (L, B, K); a second kernel adds the partials over i
// in order, × 1e-3.  No atomics: two runs give identical bits.
//
// What bounds it: the weights, read once for all rows of x (up to 64):
// L·K·N bytes (100.7 MB int8, 50.3 MB packed at B 16, K 512, N 2048, L
// 96), ~30 µs or ~15 µs at 3.35 TB/s; the partials add 2·L·B·K·4 bytes
// (6.3 MB), x is read from L2 by each block.  The probe asks whether
// packed int4 halves the weight stream's time on this card.

#include "weight_gemv.cuh"

namespace {

using namespace sa_gemv;

// Grid (K / 128 column tiles, L, row groups), stream_warps(K, N) warps;
// at one m16 tile three blocks an SM (registers capped to match), at two
// or four the accumulators' registers first.  Shared memory: a ring for
// each fold group of a round, x's piece, the fold (16·MT x 128 f32).
template <int FMT, int MT, bool VEC>
__global__ void __launch_bounds__(32 * kStreamWarps, MT == 1 ? 3 : 1)
stream_kernel(const __nv_bfloat16* __restrict__ x, int B, int K, const int8_t* __restrict__ w,
              const float* __restrict__ s, int N, int vec_x, float* __restrict__ partial) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int Kp = packed_rows(K, FMT), c = blockIdx.x, i = blockIdx.y;
  const int row0 = 16 * MT * blockIdx.z, c0 = kStreamCols * c;
  const int tid = threadIdx.x, warp = tid >> 5, nw = blockDim.x >> 5;
  const int G = stream_groups(K, N);
  const int xrows = min(Kp, piece_rows(FMT));
  const int ldx = x_row(xrows), xhalf = 16 * MT * ldx;
  // the kGroupStrips warps of a fold group share a ring and barrier 1 + gi
  const int gi = warp / kGroupStrips, h = warp % kGroupStrips, rings = nw / kGroupStrips;
  const Ring<kGroupStrips> ring{smem + gi * ring_bytes(kGroupStrips), tid % (32 * kGroupStrips),
                                1 + gi};
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + rings * ring_bytes(kGroupStrips));
  float* fold = reinterpret_cast<float*>(smem + rings * ring_bytes(kGroupStrips) +
                                         x_bytes(MT, xrows, FMT));
  const int8_t* wi = w + (long long)i * Kp * N;
  const float* si = s + (long long)i * N;
  const int pieces = (Kp + piece_rows(FMT) - 1) / piece_rows(FMT);

  for (int round = 0; round < stream_rounds(K, N); ++round) {
    const int g = gi + round * rings;  // the warp's fold group
    const bool mine = g < G;
    float acc[1][MT][4][4];
    zero(acc);
    // the group's kGroupStrips strips from column g·K + c0, those inside group g
    const Strip st{wi + stream_group_col0(K, c, g), N, stream_group_cols(K, c)};
    for (int p0 = 0; p0 < Kp; p0 += piece_rows(FMT)) {
      const int p1 = min(Kp, p0 + piece_rows(FMT));
      if (mine) ring_begin<kGroupStrips, VEC>(st, p0, p1, ring);  // in flight while x is staged
      if (round == 0 || pieces > 1) {  // x does not depend on the strip
        __syncthreads();  // every warp is done with the piece before
        stage_x<4>(x, K, B, row0, 16 * MT, Kp, FMT == kInt4 ? 2 : 1, p0, p1, xs, ldx, xhalf,
                   vec_x, tid, blockDim.x);
        __syncthreads();
      }
      if (mine)
        strip_product<FMT, MT, 1, kGroupStrips, VEC>(st, p0, p1, xs, ldx, xhalf, ring, h, acc);
    }
    // y = acc · s_i, folded over the round's groups in g order
    float sc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int oc = kStrip * h + acc_col(j, q);
        sc[j][q] = mine && c0 + oc < K ? si[g * K + c0 + oc] : 0.f;
      }
    const int g_end = min(G, (round + 1) * rings);
    for (int gg = round * rings; gg < g_end; ++gg) {
      if (mine && g == gg) {
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int e = acc_row(t, r) * kStreamCols + kStrip * h + acc_col(j, r);
              const float y = acc[0][t][j][r] * sc[j][r & 1];
              fold[e] = gg == 0 ? y : fold[e] + y;
            }
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < 16 * MT * kStreamCols; e += blockDim.x) {
    const int b = row0 + e / kStreamCols, col = c0 + e % kStreamCols;
    if (b < B && col < K) partial[((long long)i * B + b) * K + col] = fold[e];
  }
}

__global__ void reduce_kernel(const float* __restrict__ partial, int L, int n,
                              float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int i = 0; i < L; ++i) acc += partial[(long long)i * n + e] * 1e-3f;
  out[e] = acc;
}

template <int FMT, int MT, bool VEC>
cudaError_t launch_mt(int L, int B, int K, int N, const __nv_bfloat16* x, const int8_t* w,
                      const float* s, float* partial, int vec_x, cudaStream_t st) {
  static cudaError_t allowed = allow(stream_kernel<FMT, MT, VEC>, false);
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid(stream_col_tiles(K), L, row_groups(B));
  stream_kernel<FMT, MT, VEC><<<grid, 32 * stream_warps(K, N), stream_smem(B, K, N, FMT), st>>>(
      x, B, K, w, s, N, vec_x, partial);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_stream(int L, int B, int K, int N, const __nv_bfloat16* x, const int8_t* w,
                          const float* s, float* partial, int vec, int vec_x, cudaStream_t st) {
  const int mt = m_tiles(B);
  if (mt == 1)
    return vec ? launch_mt<FMT, 1, true>(L, B, K, N, x, w, s, partial, vec_x, st)
               : launch_mt<FMT, 1, false>(L, B, K, N, x, w, s, partial, vec_x, st);
  if (mt == 2)
    return vec ? launch_mt<FMT, 2, true>(L, B, K, N, x, w, s, partial, vec_x, st)
               : launch_mt<FMT, 2, false>(L, B, K, N, x, w, s, partial, vec_x, st);
  return vec ? launch_mt<FMT, kMaxTiles, true>(L, B, K, N, x, w, s, partial, vec_x, st)
             : launch_mt<FMT, kMaxTiles, false>(L, B, K, N, x, w, s, partial, vec_x, st);
}

}  // namespace

extern "C" {

// The plan's numbers of the partials' launch (gemv_plan.h): its blocks
// and each block's dynamic shared memory.
int gemv_stream_blocks(int L, int B, int K) { return stream_blocks(L, B, K); }
int gemv_stream_smem(int B, int K, int N, int int4) { return stream_smem(B, K, N, int4); }

// fmt 0: W (L, K, N) int8; fmt 1: W (L, K/2, N) packed int4.  x (B, K)
// bf16, s (L, N) f32, partial (L, B, K) f32 scratch, out (B, K) f32.  N
// must be a multiple of K.  vec: N and K multiples of 16 and W 16-byte
// aligned; vec_x: K % 16 == 0 and x 16-byte aligned.  Two launches;
// returns a cudaError_t.
int weight_stream(int fmt, int L, int B, int K, int N, const void* x, const void* w,
                  const void* s, void* partial, void* out, int vec, int vec_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sf = static_cast<const float*>(s);
  float* pf = static_cast<float*>(partial);
  cudaError_t e = fmt == 1 ? launch_stream<kInt4>(L, B, K, N, xb, wq, sf, pf, vec, vec_x, st)
                           : launch_stream<kInt8>(L, B, K, N, xb, wq, sf, pf, vec, vec_x, st);
  if (e != cudaSuccess) return (int)e;
  const int n = B * K;
  reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(pf, L, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
