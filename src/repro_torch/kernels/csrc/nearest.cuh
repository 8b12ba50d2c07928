// Shared device code of the kernels in this directory: the argmin's pair
// order, the operands' f32 values, the centroid norms, the operand type
// dispatch and the shared-memory opt-in.  The sweep
// itself is sweep_fp32.cuh's.
//
// The running (min, argmin) orders pairs by (NaN first, value, index): the
// lowest index wins a tie, which is the TPU kernel's "first index within a
// tile, strict < across tiles" rule (src/repro/kernels/fused_lloyd.py:74-86)
// stated without tiles.  The order is total, so a merge across lanes gives
// the same answer in any merge order.  The bounded sweep seeds the running
// min with the row's (ub^2, previous label) under the index -1, so the seed
// wins a tie whatever its label, as the TPU kernel's strict < against the
// seed does (src/repro/kernels/fused_lloyd.py:176-181).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pair order of the argmin: NaN first (lowest index among NaNs), then the
// smaller value, then the lower index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

// An operand element as f32: X and C come in float32 or bfloat16, and the
// FP32 sweeps and the segment sum compute in f32 on the exact upcast of a
// bf16 value, so such a launch equals the f32 launch on the upcast
// operands bit for bit.  (Where X and C are both bf16, the assignment and
// the fused step take sweep_tc.cuh's tensor-core sweep instead.)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// |c|^2 of `rows` rows of length d, one warp per row, lanes folded by a
// fixed shuffle tree (deterministic).
template <typename TC>
__global__ void row_sqnorms(const TC* __restrict__ c, int64_t rows, int d,
                            float* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const TC* cr = c + row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f32(cr[j]);
    s = fmaf(v, v, s);
  }
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

// The launchers' operand type codes: X and C are each float32 (0) or
// bfloat16 (1).  Calls f(x, c) with both cast to their element types (C
// may be null where a kernel has none); cudaErrorInvalidValue for another
// code.
template <typename F>
__host__ inline cudaError_t with_operand_types(const void* x, int x_type,
                                               const void* c, int c_type,
                                               F&& f) {
  using bf16 = __nv_bfloat16;
  const auto xf = static_cast<const float*>(x);
  const auto xb = static_cast<const bf16*>(x);
  const auto cf = static_cast<const float*>(c);
  const auto cb = static_cast<const bf16*>(c);
  if (x_type == 0 && c_type == 0) return f(xf, cf);
  if (x_type == 0 && c_type == 1) return f(xf, cb);
  if (x_type == 1 && c_type == 0) return f(xb, cf);
  if (x_type == 1 && c_type == 1) return f(xb, cb);
  return cudaErrorInvalidValue;
}

// Opt in to more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
__host__ cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
