// Deterministic reductions of the kernels' partial results.
//
// The TPU kernels fold their stats serially over row tiles (an
// "arbitrary" grid axis).  GPU blocks run in no order, and float atomics
// would change the low bits of the sums and the energy from run to run,
// which can flip the solver's accept test e_t < e_prev near convergence.
// So there are no atomics: each block writes its own partial (a slab's
// (K, d+1) stats in the segment sum, a tile's energy in the sweeps), and
// these kernels sum the partials in a fixed order.  Same inputs, same
// launch config -> bitwise the same outputs.
#pragma once

#include "nearest.cuh"

namespace repro {

// sums (R, K, d) and counts (R, K) from the partials (R, n_slabs, K, d+1),
// each summed over slabs in slab order.
__global__ void __launch_bounds__(kThreads)
reduce_slabs(const float* __restrict__ part, int n_slabs, int k, int d,
             float* __restrict__ sums, float* __restrict__ counts) {
  const int r = blockIdx.y;
  const int64_t per = (int64_t)k * (d + 1);
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= per) return;
  const float* src = part + (int64_t)r * n_slabs * per + e;
  float s = 0.f;
  // eight slabs' loads in flight at a time; the adds stay in slab order
  int p = 0;
  for (; p + 8 <= n_slabs; p += 8) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = src[(int64_t)(p + q) * per];
#pragma unroll
    for (int q = 0; q < 8; ++q) s += v[q];
  }
  for (; p < n_slabs; ++p) s += src[(int64_t)p * per];
  const int64_t kk = e / (d + 1);
  const int col = (int)(e - kk * (d + 1));
  if (col < d)
    sums[((int64_t)r * k + kk) * d + col] = s;
  else
    counts[(int64_t)r * k + kk] = s;
}

__host__ inline cudaError_t launch_reduce_slabs(cudaStream_t s, int r,
                                               const float* part, int n_slabs,
                                               int k, int d, float* sums,
                                               float* counts) {
  const int64_t elems = (int64_t)k * (d + 1);
  reduce_slabs<<<dim3((unsigned)((elems + kThreads - 1) / kThreads), r),
                 kThreads, 0, s>>>(part, n_slabs, k, d, sums, counts);
  return cudaGetLastError();
}

constexpr int kEnergyBlocks = 264;  // row ranges of the energy's first stage
constexpr int kReduceThreads = 1024;

// The energy's first stage: block (b, r) sums w * mind over the rows
// [b n / kEnergyBlocks, (b+1) n / kEnergyBlocks) of problem r (thread t the
// rows t, t + 256, ... of the range, in order, then a fixed tree) into
// part_e[r * kEnergyBlocks + b].  w null: every weight 1.
__global__ void __launch_bounds__(kThreads)
energy_rows(const float* __restrict__ mind, const float* __restrict__ w,
            int64_t w_rstride, int n, float* __restrict__ part_e) {
  __shared__ float se[kThreads];
  const int b = blockIdx.x, r = blockIdx.y, t = threadIdx.x;
  const int64_t i0 = (int64_t)b * n / kEnergyBlocks;
  const int64_t i1 = (int64_t)(b + 1) * n / kEnergyBlocks;
  const float* m = mind + (int64_t)r * n;
  const float* wr = w ? w + r * w_rstride : nullptr;
  float e = 0.f;
  for (int64_t i = i0 + t; i < i1; i += kThreads) e += (wr ? wr[i] : 1.f) * m[i];
  se[t] = e;
  __syncthreads();
  for (int off = kThreads / 2; off; off >>= 1) {
    if (t < off) se[t] += se[t + off];
    __syncthreads();
  }
  if (t == 0) part_e[(int64_t)r * kEnergyBlocks + b] = se[0];
}

// energy (R,) from part_e (R, kEnergyBlocks) and, with part_skip, skipped
// (R,) from the tiles' skipped counts (R, n_tiles): block r; thread t sums
// its contiguous share in order, then a fixed tree in shared memory, so the
// order of every addition depends on the shapes alone.
__global__ void __launch_bounds__(kReduceThreads)
reduce_step(const float* __restrict__ part_e,
            const int* __restrict__ part_skip, int n_tiles,
            float* __restrict__ energy, long long* __restrict__ skipped) {
  __shared__ float se[kReduceThreads];
  __shared__ long long ss[kReduceThreads];
  const int r = blockIdx.x, t = threadIdx.x;
  se[t] = t < kEnergyBlocks ? part_e[(int64_t)r * kEnergyBlocks + t] : 0.f;
  long long c = 0;
  if (part_skip) {
    const int j0 = (int)((int64_t)t * n_tiles / kReduceThreads);
    const int j1 = (int)((int64_t)(t + 1) * n_tiles / kReduceThreads);
    for (int j = j0; j < j1; ++j) c += part_skip[(int64_t)r * n_tiles + j];
  }
  ss[t] = c;
  __syncthreads();
  for (int off = kReduceThreads / 2; off; off >>= 1) {
    if (t < off) {
      se[t] += se[t + off];
      ss[t] += ss[t + off];
    }
    __syncthreads();
  }
  if (t == 0) {
    energy[r] = se[0];
    if (part_skip) skipped[r] = ss[0];
  }
}

// The step's energy (and skipped counts) on stream s: part_e holds
// R * kEnergyBlocks floats of scratch.
__host__ inline cudaError_t launch_energy(cudaStream_t s, int r,
                                         const float* mind, const float* w,
                                         int64_t w_rstride, int n,
                                         float* part_e, const int* part_skip,
                                         int n_tiles, float* energy,
                                         long long* skipped) {
  energy_rows<<<dim3(kEnergyBlocks, r), kThreads, 0, s>>>(mind, w, w_rstride,
                                                         n, part_e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_step<<<r, kReduceThreads, 0, s>>>(part_e, part_skip, n_tiles, energy,
                                           skipped);
  return cudaGetLastError();
}

}  // namespace repro
