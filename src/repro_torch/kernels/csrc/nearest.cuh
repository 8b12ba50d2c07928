// Shared device code of the kernels in this directory: the argmin's pair
// order, the centroid norms and the shared-memory opt-in.  The sweep
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

// |c|^2 of `rows` rows of length d, one warp per row, lanes folded by a
// fixed shuffle tree (deterministic).
__global__ void row_sqnorms(const float* __restrict__ c, int64_t rows, int d,
                            float* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* cr = c + row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s = fmaf(cr[j], cr[j], s);
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

// Opt in to more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
__host__ cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
