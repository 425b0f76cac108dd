// The weight-streaming GEMV core for Hopper (sm_90a), shared by
// int8_matmul.cu (row 2, ops/quant.py::_kernel :103, and the probes'
// packed product) and weight_stream.cu (row 9a, tools/probe_int4.py's
// make().kernel :49 and make_packed().kernel :108): y = bf16(x) · W over
// int8 weights W (K, N) or nibble-packed int4 weights (K/2, N), byte k
// holding row k in its low nibble and row k + K/2 in its high nibble.
//
// A warp owns a strip of 32 weight columns (gemv_plan.h).  SW warps on
// strips side by side share a ring of their rows (kStages slots of
// kChunk rows, filled by 16-byte cp.async with zero fill, each row's
// SW · 32 bytes copied as whole segments of one line; byte loads where N
// or the base do not allow 16-byte copies), so copies stay in flight
// while the tensor cores work.  Each warp turns its bytes to bf16 exactly
// in registers (an int8 through the f32 2^23 magic number, as row 1's
// fused_decode.cu does; a nibble n as the bf16 128 + (n ^ 8) by one
// logical op, less 136 by one bf16x2 subtraction) and runs mma.sync
// m16n8k16 with M = the rows of x: up to kMaxTiles m16 tiles of x share
// every staged weight, so each weight byte is read from device memory once
// for 64 rows.  B fragments come straight from the row-major bytes: lane
// (g, t) reads bytes 4g..4g+3 of rows 2t, 2t + 1, 2t + 8 and 2t + 9 of a
// k-step, byte j of each for n8 block j, so column c of block j is weight
// column 4c + j of the strip (acc_col undoes it).  A fragments come by
// ldmatrix from x, staged by the block as bf16 (rounded to nearest even,
// as the plain twins round it) in pieces of kXPiece columns.  Products are
// exact in f32 and summed in f32 in a fixed order: two runs give the same
// bits.
//
// What bounds it: the weights' bytes.  At 16 rows a weight byte feeds
// 32 operations (int8) or 64 (packed int4), well under the ~295
// operations per byte at which the tensor cores (989 TFLOP/s bf16) and
// not the memory (3.35 TB/s) would set the pace.  Turning bytes into
// fragments costs CUDA-core instructions per weight (not per row of x),
// which the warps of an SM must issue while their copies are in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_plan.h"
#include "mma_frag.cuh"

namespace sa_gemv {

using namespace gvp;
using frag::cp_async16;
using frag::cp_commit;
using frag::cp_wait;
using frag::ldsm4;
using frag::mma;
using frag::named_sync;
using frag::pack;
using frag::sub_bf16x2;

enum Format { kInt8 = 0, kInt4 = 1 };

// Byte j of u (a biased byte: int8 + 128) as the float it encodes: 2^23 +
// byte, less 2^23 + 128.  Exact, and so is its bf16.
__device__ __forceinline__ float biased_byte(uint32_t u, int j, float magic) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | j)) - magic;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// acc[h][t][j][r]: row 16t + g + 8 (r >> 1), strip column 8t' + 4 (r & 1)
// + j of lane (g, t') (the permutation of the B fragments undone)
__device__ __forceinline__ int acc_row(int t, int r) { return 16 * t + (lane_id() >> 2) + 8 * (r >> 1); }
__device__ __forceinline__ int acc_col(int j, int r) { return 8 * (lane_id() & 3) + 4 * (r & 1) + j; }

// The weights a ring streams: packed row k's first byte at w + k · ld,
// `cols` of its SW · 32 columns read (the rest are zeros).
struct Strip {
  const int8_t* w;
  long long ld;
  int cols;
};

// The SW warps that share a ring: its bytes, the thread's rank among the
// ring's 32 · SW threads, and the barrier they meet at (a warp barrier
// for one warp).
template <int SW>
struct Ring {
  uint8_t* base;
  int tid;
  int bar;
  __device__ __forceinline__ uint8_t* slot(int s) const { return base + s * ring_slot_bytes(SW); }
  __device__ __forceinline__ void sync() const {
    if (SW == 1)
      __syncwarp();
    else
      named_sync(bar, 32 * SW);
  }
};

// Rows [k, min(k + kChunk, kend)) of the strip into a ring slot (zeros
// past kend and past the strip's columns): 16-byte cp.async where VEC
// (N and the columns multiples of 16, the weights 16-byte aligned), else
// byte loads.
template <int SW, bool VEC>
__device__ __forceinline__ void load_chunk(const Strip& st, int k, int kend, uint8_t* slot,
                                           int tid) {
  constexpr int RB = ring_row_bytes(SW), SEG = 2 * SW;  // 16-byte segments of a row
  if (VEC) {
#pragma unroll
    for (int e = tid; e < kChunk * SEG; e += 32 * SW) {
      const int r = e / SEG, c = (e % SEG) * 16;
      const bool ok = k + r < kend && c < st.cols;
      cp_async16(slot + r * RB + c, ok ? st.w + (k + r) * st.ld + c : st.w, ok);
    }
  } else {
    for (int e = tid; e < kChunk * SW * kStrip; e += 32 * SW) {
      const int r = e / (SW * kStrip), c = e % (SW * kStrip);
      slot[r * RB + c] =
          k + r < kend && c < st.cols ? static_cast<uint8_t>(st.w[(k + r) * st.ld + c]) : 0;
    }
  }
}

// x rows [row0, row0 + 16·MT) (zeros past R) and packed columns [k0, k1)
// of every half (half h at column offset h · half_off of x), rounded to
// bf16, into xs[h · xhalf + r · ldx + k − k0], zeros up to the next ring
// chunk.  By the block's nthreads threads, BATCH 16-byte loads of a
// thread issued before any is used where vec (x rows, k0, k1 and half_off
// at 16-byte boundaries of x's type), element loads otherwise.
template <int BATCH, class XT>
__device__ void stage_x(const XT* __restrict__ x, int K, int R, int row0, int rows, int half_off,
                        int nh, int k0, int k1, uint16_t* xs, int ldx, int xhalf, bool vec,
                        int tid, int nthreads) {
  constexpr int V = 16 / sizeof(XT);  // elements of a 16-byte load
  const int nv = (x_row(k1 - k0) - kXPad) / V, total = nh * rows * nv;
  // element e's row b, column k, its source and its place in xs
  auto where = [&](int e, int& b, int& k, uint16_t*& dst) {
    const int kk = (e % nv) * V, r = (e / nv) % rows, h = e / (nv * rows);
    b = row0 + r;
    k = k0 + kk;
    dst = xs + h * xhalf + r * ldx + kk;
    return x + (long long)b * K + h * half_off + k;
  };
  for (int e0 = tid; e0 < total; e0 += BATCH * nthreads) {
    if (vec) {
      uint4 u[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        int b, k;
        uint16_t* dst;
        const XT* src = where(e0 + q * nthreads, b, k, dst);
        u[q] = e0 + q * nthreads < total && b < R && k < k1
                   ? __ldg(reinterpret_cast<const uint4*>(src))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        int b, k;
        uint16_t* dst;
        where(e0 + q * nthreads, b, k, dst);
        if (e0 + q * nthreads >= total) break;
        const XT* v = reinterpret_cast<const XT*>(&u[q]);
        uint32_t o[V / 2];
#pragma unroll
        for (int i = 0; i < V / 2; ++i)
          o[i] = __bfloat16_as_ushort(__float2bfloat16(float(v[2 * i]))) |
                 (uint32_t(__bfloat16_as_ushort(__float2bfloat16(float(v[2 * i + 1])))) << 16);
#pragma unroll
        for (int i = 0; i < V / 2; ++i) reinterpret_cast<uint32_t*>(dst)[i] = o[i];
      }
    } else {
      for (int q = 0; q < BATCH && e0 + q * nthreads < total; ++q) {
        int b, k;
        uint16_t* dst;
        const XT* src = where(e0 + q * nthreads, b, k, dst);
#pragma unroll
        for (int i = 0; i < V; ++i)
          dst[i] = b < R && k + i < k1 ? __bfloat16_as_ushort(__float2bfloat16(float(src[i]))) : 0;
      }
    }
  }
}

// The first kStages - 1 chunks of the strip's rows [k0, k1) into the
// ring (one commit group each), before strip_product drains it.
template <int SW, bool VEC>
__device__ __forceinline__ void ring_begin(const Strip& st, int k0, int k1, const Ring<SW>& ring) {
  const int n = (k1 - k0 + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_chunk<SW, VEC>(st, k0 + s * kChunk, k1, ring.slot(s), ring.tid);
    cp_commit();
  }
}

// The warp's product over packed rows [k0, k1) of strip h_strip of the
// ring, added to acc: acc[a][t][j][r] += Σ_k bf16 x[16t + row, k (half
// h)] · W[k, col] (a = h where NACC is 2, else 0: int4's two halves in
// one sum).  xs holds those rows of x from k0 on (stage_x's layout).
// ring_begin has started the ring; it is drained here.  Every warp of
// the ring calls it together; they meet once a chunk.
template <int FMT, int MT, int NACC, int SW, bool VEC>
__device__ void strip_product(const Strip& st, int k0, int k1, const uint16_t* xs, int ldx,
                              int xhalf, const Ring<SW>& ring, int h_strip,
                              float (&acc)[NACC][MT][4][4]) {
  constexpr int NH = FMT == kInt4 ? 2 : 1, RB = ring_row_bytes(SW);
  const int lane = lane_id(), gq = lane >> 2, tq = lane & 3;
  const int n = (k1 - k0 + kChunk - 1) / kChunk;
  for (int c = 0; c < n; ++c) {
    cp_wait<kStages - 2>();  // this thread's copies of chunk c are in
    ring.sync();             // and every thread's; chunk c - 1's slot is free
    const int nx = c + kStages - 1;
    if (nx < n) load_chunk<SW, VEC>(st, k0 + nx * kChunk, k1, ring.slot(nx % kStages), ring.tid);
    cp_commit();
    const uint8_t* slot = ring.slot(c % kStages) + kStrip * h_strip;
    // every k-step of the chunk: rows past k1 are zeros in the slot and in x
#pragma unroll
    for (int ks = 0; ks < kChunk / kKStep; ++ks) {
      const uint8_t* wr = slot + ks * kKStep * RB + 4 * gq;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq) * RB);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq + 1) * RB);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq + 8) * RB);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wr + (2 * tq + 9) * RB);
      const int kx = c * kChunk + ks * kKStep;
      uint32_t b0[NH][4], b1[NH][4];
      if (FMT == kInt4) {
        // byte j of rows 2t and 2t + 1 (2t + 8 and 2t + 9) side by side, then
        // each half's nibbles n as bf16 128 + (n ^ 8), less 136: exact
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t p0 = __byte_perm(w0, w1, j | ((4 + j) << 8));
          const uint32_t p1 = __byte_perm(w2, w3, j | ((4 + j) << 8));
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            b0[h][j] = sub_bf16x2(((p0 >> (4 * h)) & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
            b1[h][j] = sub_bf16x2(((p1 >> (4 * h)) & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
          }
        }
      } else {
        const uint32_t u0 = w0 ^ 0x80808080u, u1 = w1 ^ 0x80808080u;
        const uint32_t u2 = w2 ^ 0x80808080u, u3 = w3 ^ 0x80808080u;
        const float magic = 8388736.f;  // 2^23 + 128
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[0][j] = pack(biased_byte(u0, j, magic), biased_byte(u1, j, magic));
          b1[0][j] = pack(biased_byte(u2, j, magic), biased_byte(u3, j, magic));
        }
      }
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          uint32_t a[4];
          ldsm4(a, xs + h * xhalf + (16 * t + (lane & 15)) * ldx + kx + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(acc[NACC == 2 ? h : 0][t][j], a, b0[h][j], b1[h][j]);
        }
    }
  }
  ring.sync();  // every warp is done with the ring before it is filled again
}

template <int NACC, int MT>
__device__ __forceinline__ void zero(float (&acc)[NACC][MT][4][4]) {
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[a][t][j][r] = 0.f;
}

// a kernel's dynamic shared memory, once per process for each kernel:
// above 48 KB only by opting in, clusters above 8 blocks likewise
template <class F>
cudaError_t allow(F kernel, bool cluster) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemMax);
  if (e == cudaSuccess && cluster)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

}  // namespace sa_gemv
