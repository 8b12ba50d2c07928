// Asynchronous global -> shared copies, shared by the update kernel's X
// staging (cp.async, sm_80 and later) and the streamed and tensor-core
// sweeps' rings (TMA onto mbarriers, sm_90).  A cp.async copy is started,
// committed into a group, and waited for by group count; a __syncthreads()
// after the wait makes every thread's copies visible.  A TMA copy reports
// its bytes to an mbarrier, whose phase completes when the expected bytes
// and arrivals are in.
#pragma once

#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// A ring's mbarriers: kCount arrivals complete a phase (with the bytes of
// the TMA copies that an arrival announced).
template <int kCount = 1>
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "n"(kCount) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
// Waits for the completion of the phase of parity `parity`; traps after
// 2^24 polls, so a copy that went wrong fails the launch instead of
// hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  int spins = 0;
  while (!mbar_try(bar, parity))
    if (++spins > (1 << 24)) __trap();
}

// A box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma3(void* dst, const CUtensorMap* map,
                                     int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar)) : "memory");
}

// A 3-D tiled tensor map (dims and box innermost first, strides in bytes
// of the outer two), zero past its edges.  cuTensorMapEncodeTiled lives in
// libcuda; the runtime hands out its address, so nothing links libcuda.
__host__ inline cudaError_t encode3(CUtensorMap* map, CUtensorMapDataType type,
                                    const void* base, const uint64_t* dims,
                                    const uint64_t* strides,
                                    const uint32_t* box,
                                    CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const uint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace repro
