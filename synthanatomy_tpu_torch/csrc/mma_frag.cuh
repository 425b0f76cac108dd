// Fragment and staging primitives of the port's tensor-core kernels
// (band_attention.cuh for rows 6 and 8, fused_decode.cu for row 1):
// 16- and 4-byte cp.async with zero fill, ldmatrix (plain and .trans),
// mma.sync m16n8k16 (bf16 x bf16, f32 sums) and the bf16 pair packing
// of its operands; and the controls of Hopper's programmatic dependent
// launch and cluster barrier.  PTX ISA fragment layouts: for m16n8k16, lane (g =
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
