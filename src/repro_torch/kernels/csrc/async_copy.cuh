// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the update kernel's X staging and the tensor-core sweep's C ring.
// A copy is started, committed into a group, and waited for by group count;
// a __syncthreads() after the wait makes every thread's copies visible.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, any 4-byte-aligned addresses (rows of any width).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 16 bytes; both addresses 16-byte aligned.  With `src_bytes` < 16 only
// that many are read and the rest of the 16 are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

}  // namespace repro
