// Fused Performer decode step for Hopper (sm_90a): one AR token through
// all L layers of the hybrid FAVOR+/local-window prior.
//
// Replaces the TPU kernel synthanatomy_tpu/ops/fused_decode.py
// (_build_kernel, launched by make_fused_decode_step through one
// pallas_call with grid=(L,)).  Same math and rounding points; the
// plain PyTorch twin is fused_decode_step_ref in ops/fused_decode.py.
//
// What bounds it on the card: bytes.  Per token at the paper shape (24
// layers, d512, 16 heads of 64 with 8 local, window 420, ring 448, m 256,
// B16) the step moves ~82 MB of int8 weights, reads and writes the bf16
// FAVOR state S (~100 MB each way) and reads the int8 rings (~176 MB of
// K and V), against a few GFLOP: 0.149 ms at 3.35 TB/s.  Per layer that is
// ~16 MB in five launches, so each launch must spread over the SMs at
// once and keep its copies in flight.
//
// Launches, on the caller's stream, 5 a layer and one before them:
//   step_begin    h_out = h_in, and for a LayerNorm before layer 0 the
//                 tile statistics of h;
//   per layer l:
//   gemv QKV      qkv = x . Wqkv (f32), x = bf16(LayerNorm1(h)) or bf16(h);
//   attention     one block per (batch, FAVOR head), then one per (batch,
//                 local head): o (bf16, the out-projection's input), S
//                 and z in place, the token's rotated k and its v;
//   gemv out      h += o . Wout, and the tile statistics of h;
//   gemv FF1      f1 = bf16(gelu(x . W1 + b1)), x from LayerNorm2(h) or h;
//   gemv FF2      h += f1 . W2 + b2, and the tile statistics of h.
// Every launch but the first is a programmatic dependent launch: it
// starts while the kernel ahead of it still runs and copies what does not
// depend on it (weights; S, z and ring slots, its own or read only)
// before it waits for that kernel.  The step's position t is read from
// device memory (rotary angle, window and ring slots), so a CUDA graph of
// the step replays at any t.
//
// GEMVs on the tensor cores, M = batch.  A block owns 32 weight columns,
// one batch tile of 16 rows (the m16 of mma.sync m16n8k16; a smaller
// batch is zero rows) and one split of K (fused_plan.h: at least 132
// blocks a product at the paper shape).  It stages its weight rows
// (16-byte cp.async, int8 or packed int4 bytes) and its bf16 activations
// once, converts each weight byte to bf16 in registers (exact: an int8 or
// a nibble through the f32 2^23 magic number), and runs mma.sync with f32
// sums; the column scale (one per half for int4) is applied to each
// split's sum.  The splits of a column tile form one thread-block cluster:
// each adds the others' sums through distributed shared memory in split
// order (no scratch, no atomics) and finishes its share of the rows: bias,
// tanh-GELU, residual.  A LayerNorm reads its row once: the launch that
// writes h keeps each 32-column tile's mean and squared deviations, and
// the next product's blocks combine those in tile order while staging h.
//
// Attention.  FAVOR: the head's S slice (m rows of dh bf16, at stride
// B·gh·dh) and z row are copied to shared memory all at once; the block
// computes the feature maps from projT (coalesced, L2-resident), updates
// S there and writes it back 16 bytes a thread, and the numerator reads
// it from there.  Local: only the ring slots inside the window are staged
// (K and V, 16-byte cp.async, all issued up front when both fit), scores
// and P·V read them as vectors; the softmax max runs over the whole
// window, so p is rounded where the plain version rounds it.
//
// Determinism: every sum runs in a fixed order (split order, warp order,
// group order, tile order); two calls give the same bits, and a
// whole-depth call the bits of the chain of its one-layer calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "fused_plan.h"
#include "mma_frag.cuh"

namespace {

namespace cg = cooperative_groups;

using namespace fdp;
using frag::cluster_arrive;
using frag::cluster_wait;
using frag::cp_async16;
using frag::cp_async4;
using frag::cp_commit;
using frag::cp_wait;
using frag::ldsm4;
using frag::mma;
using frag::pack;
using frag::pdl_trigger;
using frag::pdl_wait;

// Timing ablations: tools/bench_fused_decode.py --ablate builds this
// source with -DFD_CUT=<mask>, each bit dropping one part of the step
// after its wait (the results are then wrong; only the time is read).
// The kernels' own build leaves FD_CUT 0 and cuts nothing.
#ifndef FD_CUT
#define FD_CUT 0
#endif
constexpr int kCutFavor = 1;       // FAVOR blocks: everything after the wait
constexpr int kCutLocal = 2;       // local blocks: everything after the wait
constexpr int kCutGemvWork = 4;    // GEMVs: staging, products and finish
constexpr int kCutFinish = 8;      // GEMVs: the cluster's sum and the finish

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));  // round-to-nearest-even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max over kAttnThreads; `red` holds one float per
// warp.  All threads get the result.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kAttnThreads / 32; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// Byte j of u (a biased byte: int8 + 128, or nibble ^ 8) as the float it
// encodes: 2^23 + byte, less 2^23 + bias.  Exact, and so is its bf16.
__device__ __forceinline__ float biased_byte(uint32_t u, int j, float magic) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | j)) - magic;
}

// ---------------------------------------------------------------------------
// LayerNorm statistics: each row read once, by the launch that wrote it
// ---------------------------------------------------------------------------

// A warp's 32 values of a row (one a lane) -> their mean and their sum of
// squared deviations, on every lane.  The roundings are explicit (no
// contraction): step_begin and a product's finishing blocks compute a tile the
// same way, so a whole-depth step and the chain of its layers agree.
__device__ __forceinline__ float2 tile_stats(float r) {
  const float mean = __fdiv_rn(warp_sum(r), 32.f);
  const float d = __fsub_rn(r, mean);
  return make_float2(mean, warp_sum(__fmul_rn(d, d)));
}

// The LayerNorm (eps 1e-6) mean and 1/sqrt(var + eps) of a row of 32·T
// values from its T tile statistics, combined in tile order (Chan, Golub
// and LeVeque's pairwise update).
__device__ float2 row_norm(const float2* st, int T) {
  float mean = st[0].x, m2 = st[0].y, n = 32.f;
  for (int t = 1; t < T; ++t) {
    const float n2 = __fadd_rn(n, 32.f);
    const float delta = __fsub_rn(st[t].x, mean);
    mean = __fadd_rn(mean, __fmul_rn(delta, __fdiv_rn(32.f, n2)));
    m2 = __fadd_rn(__fadd_rn(m2, st[t].y),
                   __fmul_rn(__fmul_rn(delta, delta), __fdiv_rn(__fmul_rn(n, 32.f), n2)));
    n = n2;
  }
  return make_float2(mean, rsqrtf(__fadd_rn(__fdiv_rn(m2, n), 1e-6f)));
}

// h_out = h_in and, where layer 0 starts with a LayerNorm, the tile
// statistics of h (stats non-null).  A warp a (row, 32-column tile).
// Launched in stream order; the QKV product may start staging its
// weights at once.
__global__ void __launch_bounds__(kGemvThreads)
step_begin_kernel(const float* __restrict__ h_in, float* __restrict__ h_out, int B, int D,
                  float2* stats) {
  pdl_trigger();
  const int p = blockIdx.x * kGemvWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (p >= B * (D / kNT)) return;
  const size_t i = (size_t)p * kNT + lane;  // row p / (D/32), tile p % (D/32)
  const float r = h_in[i];
  h_out[i] = r;
  if (stats != nullptr) {
    const float2 st = tile_stats(r);
    if (lane == 0) stats[p] = st;
  }
}

// ---------------------------------------------------------------------------
// GEMV: y[b, n] = sum_k bf16(x[b, k]) W[k, n] scale[half, n], then the
// epilogue of the last split of each tile
// ---------------------------------------------------------------------------

struct Gemv {
  const __nv_bfloat16* x;   // (B, K) bf16 activations, or null: then
  const float* h;           // the residual stream (B, K), rounded to bf16 in the staging,
  const float2* ln_stats;   // after a LayerNorm from its tile statistics (B, K/32), or none
  const float* ln_s;
  const float* ln_b;
  const int8_t* w;          // (Kp, N): int8, or packed int4 (byte k: rows k, k + K/2)
  const float* scale;       // (1 | 2, N)
  int B, K, N, rows;        // rows: packed rows of a split
  const float* bias;        // (N) or null
  int gelu;
  float* out;               // (B, N) f32 output, or null
  __nv_bfloat16* out_bf16;  // (B, N) bf16 output, or null
  float* resid;             // (B, N): resid += y, or null
  float2* stats_out;        // (B, N/32): the tile statistics of the new resid, or null
};

// A GEMV block's shared memory (dynamic, under 48 KB: fused_plan.h)
template <int NH>
struct alignas(16) GemvSmem {
  uint8_t ws[kMaxRows * kWRowBytes];    // the split's weight rows
  uint16_t xs[NH][kBT * kXRow];         // its activations, bf16 bits
  float red[kGemvWarps][kBT][kNT + 1];  // the warps' sums
  float tile[kBT][kNT];                 // the split's sum, read by the cluster
  float2 norm[kBT];                     // the rows' LayerNorm mean and 1/std
};

static_assert(sizeof(GemvSmem<1>) == gemv_smem(0) && sizeof(GemvSmem<2>) == gemv_smem(1) &&
                  gemv_smem(1) <= 48 * 1024,
              "fused_plan.h's gemv_smem is the GEMV block's shared memory");

// Grid (N / 32 column tiles, batch tiles, splits of K); the splits of a
// column tile are one thread-block cluster (fused_plan.h: at most 16).
template <bool INT4>
__global__ void __launch_bounds__(kGemvThreads) gemv_kernel(const Gemv g) {
  constexpr int NH = INT4 ? 2 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  GemvSmem<NH>& sh = *reinterpret_cast<GemvSmem<NH>*>(smem);
  auto& xs = sh.xs;
  auto& red = sh.red;
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kNT, b0 = blockIdx.y * kBT, split = blockIdx.z;
  const int Kp = INT4 ? g.K / 2 : g.K;
  const int r0 = split * g.rows, nrows = min(g.rows, Kp - r0);

  // warp w takes k-steps w, w + 4, ... of each chunk: A from ldmatrix; B
  // from lane (g, t) reading bytes 4g..4g+3 of rows 2t, 2t+1, 2t+8, 2t+9,
  // byte j of each for column block j, so column c of block j is weight
  // column 4c + j of the tile
  const int gq = lane >> 2, tq = lane & 3;
  float acc[NH][4][4];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[h][j][r] = 0.f;

  // the split's rows, kMaxRows at a time (one chunk unless K passes
  // kMaxSplits x kMaxRows packed rows, fused_plan.h)
  for (int c0 = 0; c0 < nrows; c0 += kMaxRows) {
    const int cr = min(kMaxRows, nrows - c0), rb = r0 + c0;
    if (c0 > 0) __syncthreads();  // every warp is done with the chunk before
    // the chunk's weight rows (2 x 16 bytes each), the first while the
    // kernel ahead may still run; then, once it has ended, the
    // activations (both halves for int4: x columns k and k + K/2), zero
    // rows past B
    for (int e = tid; e < 2 * cr; e += kGemvThreads) {
      const int r = e >> 1, c = (e & 1) * 16;
      cp_async16(sh.ws + r * kWRowBytes + c, g.w + (size_t)(rb + r) * g.N + n0 + c, true);
    }
    if (c0 == 0) {
      pdl_wait();
      pdl_trigger();
      if (FD_CUT & kCutGemvWork) {
        cp_commit();
        cp_wait<0>();
        cluster.sync();
        cluster.sync();
        return;
      }
    }
    if (g.x != nullptr) {
      const int xc = cr / 8;  // 16-byte chunks of an activation row
      for (int e = tid; e < NH * kBT * xc; e += kGemvThreads) {
        const int c = e % xc, b = (e / xc) % kBT, half = e / (xc * kBT);
        const bool ok = b0 + b < g.B;
        const __nv_bfloat16* src =
            g.x + (size_t)(ok ? b0 + b : 0) * g.K + half * Kp + rb + c * 8;
        cp_async16(&xs[half][b * kXRow + c * 8], src, ok);
      }
    } else {
      // h, 4 floats a load, through the LayerNorm of its row where asked
      const bool ln = g.ln_stats != nullptr;
      if (c0 == 0) {
        if (ln && tid < kBT)
          sh.norm[tid] = b0 + tid < g.B
                             ? row_norm(g.ln_stats + (size_t)(b0 + tid) * (g.K / kNT), g.K / kNT)
                             : make_float2(0.f, 0.f);
        __syncthreads();
      }
      const int hc = cr / 4;
      for (int e = tid; e < NH * kBT * hc; e += kGemvThreads) {
        const int c = e % hc, b = (e / hc) % kBT, half = e / (hc * kBT);
        const int k = half * Kp + rb + 4 * c;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (b0 + b < g.B) {
          const float4 u =
              __ldcg(reinterpret_cast<const float4*>(g.h + (size_t)(b0 + b) * g.K + k));
          v[0] = u.x;
          v[1] = u.y;
          v[2] = u.z;
          v[3] = u.w;
          if (ln)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], sh.norm[b].x), sh.norm[b].y),
                                         g.ln_s[k + i]), g.ln_b[k + i]);
        }
        uint2 pk;
        pk.x = pack(v[0], v[1]);
        pk.y = pack(v[2], v[3]);
        *reinterpret_cast<uint2*>(&xs[half][b * kXRow + 4 * c]) = pk;
      }
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    for (int s = warp; s < cr / kKStep; s += kGemvWarps) {
      const uint8_t* wr = sh.ws + s * kKStep * kWRowBytes + 4 * gq;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq) * kWRowBytes);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq + 1) * kWRowBytes);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq + 8) * kWRowBytes);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq + 9) * kWRowBytes);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        uint32_t a[4];
        ldsm4(a, &xs[h][(lane & 15) * kXRow + s * kKStep + (lane >> 4) * 8]);
        uint32_t u0, u1, u2, u3;
        float magic;
        if (INT4) {  // nibble n encodes (n ^ 8) - 8
          const int sh4 = 4 * h;
          u0 = ((w0 >> sh4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          u1 = ((w1 >> sh4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          u2 = ((w2 >> sh4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          u3 = ((w3 >> sh4) & 0x0F0F0F0Fu) ^ 0x08080808u;
          magic = 8388616.f;  // 2^23 + 8
        } else {
          u0 = w0 ^ 0x80808080u;
          u1 = w1 ^ 0x80808080u;
          u2 = w2 ^ 0x80808080u;
          u3 = w3 ^ 0x80808080u;
          magic = 8388736.f;  // 2^23 + 128
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma(acc[h][j], a, pack(biased_byte(u0, j, magic), biased_byte(u1, j, magic)),
              pack(biased_byte(u2, j, magic), biased_byte(u3, j, magic)));
      }
    }
  }

  // scale; acc[h][j][r] is row gq + 8 (r >> 1), column 8 tq + 4 (r & 1) + j
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = 8 * tq + 4 * (r & 1) + j;
      float y = acc[0][j][r] * g.scale[n0 + col];
      if (INT4) y += acc[NH - 1][j][r] * g.scale[g.N + n0 + col];
      red[warp][gq + 8 * (r >> 1)][col] = y;
    }
  __syncthreads();
  for (int e = tid; e < kBT * kNT; e += kGemvThreads) {
    const int b = e / kNT, c = e % kNT;
    sh.tile[b][c] = red[0][b][c] + red[1][b][c] + red[2][b][c] + red[3][b][c];
  }

  // The cluster's splits add each other's sums in split order, split r
  // taking rows r, r + S, ... of the tile, a warp a row (lane = column)
  // for its tile statistics, and finish them: bias, GELU, residual.  What
  // the finish reads from memory is loaded before the barrier.
  constexpr int kRows = kBT / kGemvWarps;  // rows of a warp, at most
  const int S = gridDim.z, n = n0 + lane;
  const float bias = g.bias != nullptr ? g.bias[n] : 0.f;
  float res[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int br = split + S * (warp + kGemvWarps * i), b = b0 + br;
    res[i] = g.resid != nullptr && br < kBT && b < g.B ? g.resid[(size_t)b * g.N + n] : 0.f;
  }
  if (FD_CUT & kCutFinish) return;
  cluster.sync();
  float sum[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int br = split + S * (warp + kGemvWarps * i);
    sum[i] = 0.f;
    if (br >= kBT || b0 + br >= g.B) continue;  // the same for the whole warp
    float v[kMaxSplits];
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < S) v[z] = *cluster.map_shared_rank(&sh.tile[br][lane], z);
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < S) sum[i] += v[z];
  }
  cluster_arrive();  // this block has read the others' tiles
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int br = split + S * (warp + kGemvWarps * i), b = b0 + br;
    if (br >= kBT || b >= g.B) continue;
    float r = sum[i];
    if (g.bias != nullptr) r += bias;
    if (g.gelu) r = gelu_tanh(r);
    const size_t o = (size_t)b * g.N + n;
    if (g.resid != nullptr) {
      r = res[i] + r;
      g.resid[o] = r;
    }
    if (g.out != nullptr) g.out[o] = r;
    if (g.out_bf16 != nullptr) g.out_bf16[o] = __float2bfloat16(r);
    if (g.stats_out != nullptr) {
      const float2 st = tile_stats(r);
      if (lane == 0) g.stats_out[(size_t)b * (g.N / kNT) + blockIdx.x] = st;
    }
  }
  cluster_wait();  // the tile stays until every split has read it
}

// ---------------------------------------------------------------------------
// attention: FAVOR blocks (batch x global head), then local blocks
// (batch x local head), one launch
// ---------------------------------------------------------------------------

struct Attn {
  const float* qkv;          // (B, 3·H·dh): q, k, v
  __nv_bfloat16* o;          // (B, H·dh): FAVOR heads, then local heads
  const long long* t;        // the step's position
  int B, H, gh, lh, dh, m, R, W, cap;  // cap: ring slots a staging buffer holds
  const float* projT;        // (dh, m)
  __nv_bfloat16* S;          // (m, B·gh·dh), in place
  float* z;                  // (B·gh, m), in place
  float dn, diag_c, ratio;   // dh^-1/4, dn²/2, m^-1/2
  const void* ck;            // (R, B·lh·dh) int8 or bf16
  const void* cv;
  const float* ck_s;         // (R, B·lh) for int8 rings, else null
  const float* cv_s;
  float* k_out;              // (B·lh·dh): the token's rotated k and its v
  float* v_out;
  float att_scale, rot_c;    // dh^-1/2, −2 ln(10000)/dh
};

__device__ void favor_block(const Attn& a, uint8_t* smem) {
  const int bh = blockIdx.x, Bg = a.B * a.gh, b = bh / a.gh, hh = bh % a.gh;
  const int dh = a.dh, m = a.m, tid = threadIdx.x, HD = a.H * dh;
  const int rowb = row_bytes(dh, 2), cpr = dh / 8;  // 16-byte chunks of an S row
  uint8_t* Ss = smem;
  float* q = reinterpret_cast<float*>(smem + (size_t)m * rowb);
  float* k = q + dh;
  float* v = k + dh;
  float* qp = v + dh;  // m
  float* kp = qp + m;  // m
  float* red = kp + m;
  float* part = red + kRedFloats;
  float* zs = part + kPartFloats;  // m: the head's z row
  const size_t ld = (size_t)Bg * dh;
  __nv_bfloat16* Sg = a.S + (size_t)bh * dh;
  float* zr = a.z + (size_t)bh * m;

  // the head's S slice and z row (this launch's own), every copy issued
  // before the kernel ahead ends
  for (int e = tid; e < m * cpr; e += kAttnThreads) {
    const int j = e / cpr, c = e % cpr;
    cp_async16(Ss + j * rowb + c * 16, Sg + (size_t)j * ld + c * 8, true);
  }
  for (int j = tid; j < m; j += kAttnThreads) cp_async4(zs + j, zr + j, true);
  cp_commit();
  pdl_wait();  // qkv
  pdl_trigger();
  if (FD_CUT & kCutFavor) {
    cp_wait<0>();
    return;
  }

  const float* row = a.qkv + (size_t)b * 3 * HD + hh * dh;
  for (int d = tid; d < dh; d += kAttnThreads) {
    q[d] = row[d];
    k[d] = row[HD + d];
    v[d] = row[2 * HD + d];
  }
  cp_wait<0>();
  __syncthreads();

  // diag = sum_d x_d^2 dn^2/2: warp 0 for q, warp 1 for k (red[16], red[17])
  if (tid < 64) {
    const float* x = tid < 32 ? q : k;
    float sq = 0.f;
    for (int d = tid & 31; d < dh; d += 32) sq += (x[d] * x[d]) * a.diag_c;
    sq = warp_sum(sq);
    if ((tid & 31) == 0) red[16 + (tid >> 5)] = sq;
  }
  __syncthreads();
  const float diag_q = red[16], diag_k = red[17];
  // dash = (x dn) projT, a feature a thread (coalesced rows of projT,
  // L2-resident); queries stabilised by their max over all m features
  float mx = -INFINITY;
  for (int j = tid; j < m; j += kAttnThreads) {
    float dq = 0.f, dk = 0.f;
    for (int d0 = 0; d0 < dh; d0 += 16) {  // 16 loads in flight
      float p[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) p[i] = __ldg(a.projT + (size_t)(d0 + i) * m + j);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dq += (q[d0 + i] * a.dn) * p[i];
        dk += (k[d0 + i] * a.dn) * p[i];
      }
    }
    qp[j] = dq;
    kp[j] = a.ratio * (expf(dk - diag_k) + 1e-4f);
    mx = fmaxf(mx, dq);
  }
  const float stab = block_reduce<true>(mx, red);

  float den = 0.f;
  for (int j = tid; j < m; j += kAttnThreads) {
    const float p = a.ratio * (expf(qp[j] - diag_q - stab) + 1e-4f);
    qp[j] = p;
    const float zn = zs[j] + kp[j];
    zr[j] = zn;
    den += p * zn;
  }
  den = fmaxf(block_reduce<false>(den, red), 1e-12f);  // syncs

  // S[j, d] += k'_j v_d (f32 sums, bf16 storage): in shared memory, and
  // back to the state, 16 bytes a thread
  for (int e = tid; e < m * cpr; e += kAttnThreads) {
    const int j = e / cpr, c = e % cpr;
    uint4* sp = reinterpret_cast<uint4*>(Ss + j * rowb + c * 16);
    uint4 u = *sp;
    __nv_bfloat16* s8 = reinterpret_cast<__nv_bfloat16*>(&u);
    const float kj = kp[j];
#pragma unroll
    for (int i = 0; i < 8; ++i) s8[i] = __float2bfloat16(__bfloat162float(s8[i]) + kj * v[c * 8 + i]);
    *sp = u;
    *reinterpret_cast<uint4*>(Sg + (size_t)j * ld + c * 8) = u;
  }
  __syncthreads();

  // num[d] = sum_j bf16(q'_j) S[j, d]: 8 columns a thread, the rows split
  // over groups, folded in group order
  const int ngrp = kAttnThreads / cpr, grp = tid / cpr, c = tid % cpr;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int j = grp; j < m; j += ngrp) {
    const float qb = bf16_round(qp[j]);
    const uint4 u = *reinterpret_cast<const uint4*>(Ss + j * rowb + c * 16);
    const __nv_bfloat16* s8 = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += qb * __bfloat162float(s8[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[grp * dh + c * 8 + i] = acc[i];
  __syncthreads();
  for (int d = tid; d < dh; d += kAttnThreads) {
    float s = 0.f;
    for (int gi = 0; gi < ngrp; ++gi) s += part[gi * dh + d];
    a.o[(size_t)b * HD + hh * dh + d] = __float2bfloat16(s / den);
  }
}

// T: int8_t (int8 rings with per-(slot, head) scales) or __nv_bfloat16
template <class T>
__device__ void local_block(const Attn& a, uint8_t* smem, int c) {
  constexpr bool RQ = sizeof(T) == 1;
  constexpr int VEC = 16 / sizeof(T);  // ring elements of a 16-byte chunk
  const int Bl = a.B * a.lh, b = c / a.lh, hl = c % a.lh;
  const int dh = a.dh, tid = threadIdx.x, HD = a.H * dh, half = dh / 2;
  const int rowb = row_bytes(dh, sizeof(T)), cpr = dh / VEC, cap = a.cap;
  const int t = (int)*a.t;
  const int p0 = window_first(t, a.R, a.W);  // the window: positions p0 .. t − 1
  const int nv = t - p0;
  const bool whole = nv <= cap;  // K and V staged side by side, up front

  uint8_t* Kb = smem;
  uint8_t* Vb = smem + (size_t)cap * rowb;
  float* qr = reinterpret_cast<float*>(smem + (size_t)2 * cap * rowb);
  float* kr = qr + dh;
  float* vl = kr + dh;
  float* raw = vl + dh;       // 2 dh: q and k before the rotation
  float* rot = raw + 2 * dh;  // 2 dh: cos, sin of the rotary at t
  const int wr = imax(1, window_rows(a.R, a.W));
  float* sc = rot + 2 * dh;   // the window's scores, then its rounded probabilities
  float* ks = sc + wr;        // its K and V scales (int8 rings)
  float* vs = ks + wr;
  float* red = vs + wr;
  float* part = red + kRedFloats;

  const size_t BLd = (size_t)Bl * dh;
  const T* ck = static_cast<const T*>(a.ck) + (size_t)c * dh;
  const T* cv = static_cast<const T*>(a.cv) + (size_t)c * dh;
  // window rows i0 .. i0+n-1 of one ring into a buffer (one commit group)
  auto stage = [&](uint8_t* buf, const T* ring, int i0, int n) {
    for (int e = tid; e < n * cpr; e += kAttnThreads) {
      const int i = e / cpr, cc = e % cpr;
      const int slot = (p0 + i0 + i) % a.R;
      cp_async16(buf + i * rowb + cc * 16, ring + (size_t)slot * BLd + cc * VEC, true);
    }
    cp_commit();
  };
  // Before the kernel ahead ends (the rings are read only, t was written
  // before the step): the window's scales (with K's copies), K and V, and
  // the rotary's cos and sin at t.
  if (RQ)
    for (int i = tid; i < nv; i += kAttnThreads) {
      const size_t o = (size_t)((p0 + i) % a.R) * Bl + c;
      cp_async4(ks + i, a.ck_s + o, true);
      cp_async4(vs + i, a.cv_s + o, true);
    }
  if (whole) {
    stage(Kb, ck, 0, nv);
    stage(Vb, cv, 0, nv);
  }
  for (int d = tid; d < dh; d += kAttnThreads) {
    const float ang = (float)t * expf((float)(d % half) * a.rot_c);
    rot[d] = cosf(ang);
    rot[dh + d] = sinf(ang);
  }
  pdl_wait();  // qkv
  pdl_trigger();
  if (FD_CUT & kCutLocal) {
    cp_wait<0>();
    return;
  }

  const float* row = a.qkv + (size_t)b * 3 * HD + (a.gh + hl) * dh;
  for (int d = tid; d < dh; d += kAttnThreads) {
    raw[d] = row[d];
    raw[dh + d] = row[HD + d];
    vl[d] = row[2 * HD + d];
  }
  __syncthreads();
  // rotary at position t (rotate-half within the head)
  for (int d = tid; d < dh; d += kAttnThreads) {
    const float cs = rot[d], sn = rot[dh + d];
    const float pq = d < half ? -raw[d + half] : raw[d - half];
    const float pk = d < half ? -raw[dh + d + half] : raw[dh + d - half];
    qr[d] = raw[d] * cs + pq * sn;
    kr[d] = raw[dh + d] * cs + pk * sn;
  }
  __syncthreads();
  // the token's own score, by warp 0 (red[16]: read after the next
  // reduction's barriers)
  if (tid < 32) {
    float self = 0.f;
    for (int d = tid; d < dh; d += 32) self += bf16_round(qr[d] * kr[d]);
    self = warp_sum(self);
    if (tid == 0) red[16] = self * a.att_scale;
  }

  // scores: a slot a thread, its row read 16 bytes at a time
  for (int i0 = 0; i0 < nv; i0 += cap) {
    const int n = min(cap, nv - i0);
    if (whole) {
      cp_wait<1>();  // K; V may still be in flight
    } else {
      stage(Kb, ck, i0, n);
      cp_wait<0>();
    }
    __syncthreads();
    for (int i = tid; i < n; i += kAttnThreads) {
      const uint8_t* kr8 = Kb + i * rowb;
      float s = 0.f;
      for (int cc = 0; cc < cpr; ++cc) {
        const uint4 u = *reinterpret_cast<const uint4*>(kr8 + cc * 16);
        const T* e8 = reinterpret_cast<const T*>(&u);
        const float* qd = qr + cc * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += bf16_round(to_f(e8[e]) * qd[e]);
      }
      s *= a.att_scale;
      if (RQ) s *= ks[i0 + i];
      sc[i0 + i] = s;
    }
    __syncthreads();
  }
  // softmax over the whole window and the token itself
  float mx_part = -INFINITY;
  for (int i = tid; i < nv; i += kAttnThreads) mx_part = fmaxf(mx_part, sc[i]);
  const float mx_ring = block_reduce<true>(mx_part, red);
  const float s_self = red[16];
  const float mx = fmaxf(mx_ring, s_self);
  const float p_self = expf(s_self - mx);
  float den_part = 0.f;
  for (int i = tid; i < nv; i += kAttnThreads) {
    const float p = expf(sc[i] - mx);
    den_part += p;
    sc[i] = bf16_round(RQ ? p * vs[i] : p);
  }
  const float den = block_reduce<false>(den_part, red) + p_self;  // syncs

  // P·V: 4 columns a thread, the slots split over groups, folded in group order
  const int tpr = dh / 4, ngrp = kAttnThreads / tpr, grp = tid / tpr, d0 = (tid % tpr) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < nv; i0 += cap) {
    const int n = min(cap, nv - i0);
    if (!whole) stage(Vb, cv, i0, n);
    cp_wait<0>();
    __syncthreads();
    for (int i = grp; i < n; i += ngrp) {
      const float p = sc[i0 + i];
      const uint8_t* vr = Vb + i * rowb + d0 * sizeof(T);
      if (RQ) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(vr);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += p * (float)(int8_t)(w >> (8 * e));
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(vr);
        const __nv_bfloat16* e4 = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += p * __bfloat162float(e4[e]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) part[grp * dh + d0 + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < dh; d += kAttnThreads) {
    float s = 0.f;
    for (int gi = 0; gi < ngrp; ++gi) s += part[gi * dh + d];
    a.o[(size_t)b * HD + (a.gh + hl) * dh + d] = __float2bfloat16((s + p_self * vl[d]) / den);
    a.k_out[(size_t)c * dh + d] = kr[d];
    a.v_out[(size_t)c * dh + d] = vl[d];
  }
}

template <class T>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(const Attn a) {
  extern __shared__ __align__(16) uint8_t smem[];
  if ((int)blockIdx.x < a.B * a.gh)
    favor_block(a, smem);
  else
    local_block<T>(a, smem, (int)blockIdx.x - a.B * a.gh);
}

// Launch `kernel` so that it may start before the kernel ahead of it on
// the stream ends (programmatic dependent launch; it waits in
// pdl_wait()), in clusters of `cluster_z` blocks along z (0: none).
template <class... P, class... A>
cudaError_t launch_pdl(void (*kernel)(P...), dim3 grid, int threads, int smem,
                       cudaStream_t stream, int cluster_z, A... args) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = cluster_z;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_z > 0 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

cudaError_t gemv(Gemv g, int int4, cudaStream_t stream) {
  const int Kp = packed_rows(g.K, int4);
  g.rows = split_rows(Kp, g.N, g.B);
  const dim3 grid(col_tiles(g.N), batch_tiles(g.B), splits(Kp, g.N, g.B));
  return int4 ? launch_pdl(gemv_kernel<true>, grid, kGemvThreads, gemv_smem(1), stream, grid.z, g)
              : launch_pdl(gemv_kernel<false>, grid, kGemvThreads, gemv_smem(0), stream, grid.z, g);
}

// Let the attention kernel take the dynamic shared memory its launches
// ask for (above 48 KB only by opting in), and the GEMVs clusters of up
// to 16 blocks (above 8 only by opting in); once per process, before any
// capture.
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attention_kernel<int8_t>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax)) ||
      (err = cudaFuncSetAttribute(attention_kernel<__nv_bfloat16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax)) ||
      (err = cudaFuncSetAttribute(gemv_kernel<false>,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) ||
      (err = cudaFuncSetAttribute(gemv_kernel<true>,
                                  cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
    return err;
  done = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan's sizes, for the wrapper (fused_plan.h).
int fused_decode_fits(int D, int H, int dh, int F, int int4) { return gemv_fits(D, H * dh, F, int4); }

int fused_decode_attn_smem(int dh, int m, int lh, int R, int W, int ring_quant) {
  return attn_smem(dh, m, lh, R, W, ring_quant ? 1 : 2);
}

// One decode step through all L layers (5 L + 1 launches).  t points to
// the step's position (int64, on the device).  h_out receives the
// residual stream; S, z are updated in place; k_out/v_out (L, B·lh·dh)
// receive the token's rotated keys and values for the ring write.
// Scratch: qkv (B, 3·H·dh) f32; stats (B, D/32) float2, the LayerNorms'
// tile statistics; o (B, H·dh), f1 (B, F) bf16.
// Constants come from the caller, rounded from double as the JAX
// reference rounds its Python scalars: dn = dh^-1/4, diag_c = dn^2/2,
// ratio = m^-1/2, att_scale = dh^-1/2, rot_c = -2 ln(10000)/dh.
// Returns the first CUDA error (0 when every launch was accepted).
int fused_decode_step(
    int L, int B, int D, int H, int dh, int lh, int m, int R, int W, int F,
    int int4, int rezero, int ring_quant, const long long* t,
    float dn, float diag_c, float ratio, float att_scale, float rot_c,
    const float* h_in, float* h_out,
    const float* ln1_s, const float* ln1_b, const float* ln2_s, const float* ln2_b,
    const int8_t* wqkv_q, const float* wqkv_s, const int8_t* wout_q, const float* wout_s,
    const int8_t* w1_q, const float* w1_s, const float* b1,
    const int8_t* w2_q, const float* w2_s, const float* b2,
    const float* projT, __nv_bfloat16* S, float* z,
    const void* ck, const void* cv, const float* ck_s, const float* cv_s,
    float* k_out, float* v_out,
    float* qkv, float2* stats, __nv_bfloat16* o, __nv_bfloat16* f1, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int gh = H - lh, HD = H * dh, N3 = 3 * HD;
  const int Bg = B * gh, Bl = B * lh;
  const int kdiv = int4 ? 2 : 1, nsc = int4 ? 2 : 1;
  const int elem = ring_quant ? 1 : 2;
  const int smem = attn_smem(dh, m, lh, R, W, elem);
  if (smem > kSmemMax || !gemv_fits(D, HD, F, int4) || dh % 16 != 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return err;
  float2* ln_stats = rezero ? nullptr : stats;

  step_begin_kernel<<<ceil_div(B * (D / kNT), kGemvWarps), kGemvThreads, 0, stream>>>(
      h_in, h_out, B, D, ln_stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  for (int l = 0; l < L; ++l) {
    Gemv g{};
    g.B = B;
    // QKV, from LayerNorm1(h) (pre-LN) or h (ReZero)
    g.h = h_out;
    g.ln_stats = ln_stats;
    g.ln_s = rezero ? nullptr : ln1_s + (size_t)l * D;
    g.ln_b = rezero ? nullptr : ln1_b + (size_t)l * D;
    g.K = D;
    g.N = N3;
    g.w = wqkv_q + (size_t)l * (D / kdiv) * N3;
    g.scale = wqkv_s + (size_t)l * nsc * N3;
    g.out = qkv;
    if ((err = gemv(g, int4, stream)) != cudaSuccess) return err;
    // attention
    Attn a{};
    a.qkv = qkv;
    a.o = o;
    a.t = t;
    a.B = B;
    a.H = H;
    a.gh = gh;
    a.lh = lh;
    a.dh = dh;
    a.m = m;
    a.R = R;
    a.W = W;
    a.cap = local_cap(dh, R, W, elem);
    a.projT = projT + (size_t)l * dh * m;
    a.S = S + (size_t)l * m * Bg * dh;
    a.z = z + (size_t)l * Bg * m;
    a.dn = dn;
    a.diag_c = diag_c;
    a.ratio = ratio;
    if (lh > 0) {
      const size_t ring = (size_t)l * R * Bl * dh * elem, rs = (size_t)l * R * Bl;
      a.ck = static_cast<const char*>(ck) + ring;
      a.cv = static_cast<const char*>(cv) + ring;
      a.ck_s = ring_quant ? ck_s + rs : nullptr;
      a.cv_s = ring_quant ? cv_s + rs : nullptr;
      a.k_out = k_out + (size_t)l * Bl * dh;
      a.v_out = v_out + (size_t)l * Bl * dh;
    }
    a.att_scale = att_scale;
    a.rot_c = rot_c;
    err = ring_quant ? launch_pdl(attention_kernel<int8_t>, dim3(Bg + Bl), kAttnThreads, smem,
                                  stream, 0, a)
                     : launch_pdl(attention_kernel<__nv_bfloat16>, dim3(Bg + Bl), kAttnThreads,
                                  smem, stream, 0, a);
    if (err != cudaSuccess) return err;
    // out-projection + residual, with the statistics of LayerNorm2
    g.h = nullptr;
    g.ln_stats = nullptr;
    g.ln_s = g.ln_b = nullptr;
    g.out = nullptr;
    g.x = o;
    g.K = HD;
    g.N = D;
    g.w = wout_q + (size_t)l * (HD / kdiv) * D;
    g.scale = wout_s + (size_t)l * nsc * D;
    g.resid = h_out;
    g.stats_out = ln_stats;
    if ((err = gemv(g, int4, stream)) != cudaSuccess) return err;
    // FF1 + b1 + GELU, from LayerNorm2(h) or h
    g.x = nullptr;
    g.resid = nullptr;
    g.stats_out = nullptr;
    g.h = h_out;
    g.ln_stats = ln_stats;
    g.ln_s = rezero ? nullptr : ln2_s + (size_t)l * D;
    g.ln_b = rezero ? nullptr : ln2_b + (size_t)l * D;
    g.K = D;
    g.N = F;
    g.w = w1_q + (size_t)l * (D / kdiv) * F;
    g.scale = w1_s + (size_t)l * nsc * F;
    g.bias = b1 + (size_t)l * F;
    g.gelu = 1;
    g.out_bf16 = f1;
    if ((err = gemv(g, int4, stream)) != cudaSuccess) return err;
    // FF2 + b2 + residual, with the statistics of layer l + 1's LayerNorm1
    g.h = nullptr;
    g.ln_stats = nullptr;
    g.ln_s = g.ln_b = nullptr;
    g.gelu = 0;
    g.out_bf16 = nullptr;
    g.x = f1;
    g.K = F;
    g.N = D;
    g.w = w2_q + (size_t)l * (F / kdiv) * D;
    g.scale = w2_s + (size_t)l * nsc * D;
    g.bias = b2 + (size_t)l * D;
    g.resid = h_out;
    g.stats_out = l + 1 < L ? ln_stats : nullptr;
    if ((err = gemv(g, int4, stream)) != cudaSuccess) return err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
