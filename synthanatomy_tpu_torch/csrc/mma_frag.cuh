// Fragment and staging primitives of the port's tensor-core kernels
// (band_attention.cuh for rows 6 and 8, fused_decode.cu for row 1,
// res_tile.cuh for row 7, weight_gemv.cuh for rows 2 and 9a,
// launch_overhead.cu for row 9c): 16- and 4-byte cp.async with zero fill,
// ldmatrix (plain and .trans), mma.sync m16n8k16 (bf16 x bf16, f32 sums)
// and the bf16 pair packing and subtraction of its operands; the warpgroup product
// wgmma (A from registers, B from shared memory); and the controls of
// Hopper's programmatic dependent launch and cluster barrier.  PTX ISA fragment layouts: for m16n8k16, lane (g =
// lane / 4, t = lane % 4) holds A rows g and g + 8 at k 2t, 2t + 1 (a0,
// a1) and k 2t + 8, 2t + 9 (a2, a3); B column g at k 2t, 2t + 1 (b0) and
// 2t + 8, 2t + 9 (b1); C rows g and g + 8 at columns 2t, 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace frag {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (zeros if !ok: no byte is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a − b on two bf16 pairs (sm_90), each half rounded to nearest even
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Warpgroup products (sm_90a wgmma): a warpgroup's m64 x n128 x k16 with
// f32 sums in 64 registers a thread, A from registers (each warp's 16 rows
// in the mma.sync m16n8k16 A layout above), B (N x K, K contiguous) from
// shared memory through a descriptor.  Thread (warp w of the group, lane
// g·4 + t) holds rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t +
// 1 in d[4j], d[4j + 1] (row 16w + g) and d[4j + 2], d[4j + 3].

// The descriptor of a bf16 B tile in shared memory in wgmma's 128-byte
// swizzle (16-byte chunk c of a 128-byte row r at c ^ (r % 8); atoms of 8
// rows, 1024-byte aligned), starting `off` bytes in.  K-major (N x K, K
// contiguous: rows of 64 k): sbo the bytes between 8-row groups of N, lbo
// unused.  MN-major (K x N, N contiguous: rows of 64 n, for the .trans
// product): lbo the bytes between 64-column blocks of N, sbo between
// 8-row groups of K.
__device__ __forceinline__ uint64_t wg_desc_sw128(const void* tile, int off, int lbo, int sbo) {
  const uint64_t addr = smem_addr(tile) + off;
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous product (place after the wait and before the
// first product)
template <int N>
__device__ __forceinline__ void wg_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wait until at most N of the warpgroup's product groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A·B (m64 n128 k16), A in registers, B by descriptor: K-major
// (kTransB 0) or MN-major (kTransB 1)
template <int kTransB>
__device__ __forceinline__ void wg_mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(kTransB));
}

// d += A·B (m64 n64 k16): as wg_mma_rs, 32 f32 sums a thread (columns 8j +
// 2t and 8j + 2t + 1 for j < 8)
template <int kTransB>
__device__ __forceinline__ void wg_mma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(kTransB));
}

// Barrier `id` (1-15; 0 is __syncthreads') of `threads` threads of the
// block, whole warps: the warps of a block that share a ring meet here.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Programmatic dependent launch (sm_90).  A kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it on the stream ends; pdl_wait() returns once that
// kernel has ended and its writes are visible (at once for a kernel
// launched without the attribute).  pdl_trigger() lets the next such
// kernel start; called after pdl_wait(), it lets a kernel overlap only
// the one right ahead of it.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The two halves of a thread-block cluster's barrier (cluster.sync() is
// both at once): arrive once this block's reads of the others' shared
// memory are done, wait before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace frag
