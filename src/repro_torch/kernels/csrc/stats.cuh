// Deterministic weighted cluster statistics, shared by the fused step, the
// bounded fused step and the update kernel.
//
// The TPU kernels fold their stats serially over row tiles (an
// "arbitrary" grid axis).  GPU blocks run in no order, and float atomics
// would change the low bits of the sums and the energy from run to run,
// which can flip the solver's accept test e_t < e_prev near convergence.
// So there are no atomics:
//   1. block (slab, r) owns a fixed contiguous slab of row tiles and its
//      own partial stats (K, d+1) in device memory (`zero_partials`, then
//      `add_tile_stats` after each tile, rows in a fixed order);
//   2. `reduce_slabs` sums each (cluster, column) over the slabs in slab
//      order.
// Same inputs, same launch config -> bitwise the same outputs.  The slab
// count P comes from the wrapper (tiles.slab_layout), in units of the
// kTN-row tiles of nearest.cuh.
#pragma once

#include "nearest.cuh"

namespace repro {

__device__ __forceinline__ void zero_partials(float* __restrict__ pr, int k,
                                              int d) {
  for (int64_t e = threadIdx.x; e < (int64_t)k * (d + 1); e += kThreads)
    pr[e] = 0.f;
}

// Adds the tile's weighted one-hot stats into the slab's partials pr
// (K, d+1): column d is the weight total.  Reads sm.lab (a label outside
// [0, k) adds nothing), sm.w and the X tile in sm.xs.  One thread per column,
// the tile's rows in groups of eight.  Rows of a group that share a
// label are summed first, in row order; then each distinct label's
// partial is read and written back once, so up to eight reads are in
// flight instead of one.  The order of every addition is fixed by the
// data alone.
__device__ void add_tile_stats(const Smem& sm, int rows, int k, int d,
                               float* __restrict__ pr) {
  const int dp1 = d + 1;
  for (int col = threadIdx.x; col < dp1; col += kThreads) {
    const float* xcol = sm.xs + (size_t)col * kXLd;
    for (int i0 = 0; i0 < rows; i0 += 8) {
      int l[8];
      float v[8], p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j;
        l[j] = i < rows && (unsigned)sm.lab[i] < (unsigned)k ? sm.lab[i] : -1;
        v[j] = i < rows ? (col < d ? sm.w[i] * xcol[i] : sm.w[i]) : 0.f;
      }
#pragma unroll
      for (int j = 1; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < j; ++q)
          if (l[j] >= 0 && l[j] == l[q]) {
            v[q] += v[j];
            l[j] = -1;
          }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p[j] = l[j] >= 0 ? pr[(int64_t)l[j] * dp1 + col] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (l[j] >= 0) pr[(int64_t)l[j] * dp1 + col] = p[j] + v[j];
    }
  }
}

// Everything a tile contributes once sm.lab / sm.mind hold its
// assignment: the real rows' labels and distances to lab_out / mind_out
// (already offset to the tile's first row), the stats into pr, and the
// tile's weighted energy, returned in threads 0-31 (a fixed shuffle tree;
// 0 in the others).
__device__ float emit_tile(const Smem& sm, int rows, int k, int d,
                           int* __restrict__ lab_out,
                           float* __restrict__ mind_out,
                           float* __restrict__ pr) {
  if (threadIdx.x < rows) {
    lab_out[threadIdx.x] = sm.lab[threadIdx.x];
    mind_out[threadIdx.x] = sm.mind[threadIdx.x];
  }
  float s = 0.f;
  if (threadIdx.x < 32) {
    for (int i = threadIdx.x; i < rows; i += 32) s += sm.w[i] * sm.mind[i];
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  add_tile_stats(sm, rows, k, d, pr);
  return s;
}

// sums (R, K, d) and counts (R, K) from the partials, each summed over
// slabs in slab order.  With part_e, energy (R,) likewise (element
// K*(d+1) of problem r); with part_skip, skipped (R,) (element K*(d+1)+1).
__global__ void __launch_bounds__(kThreads)
reduce_slabs(const float* __restrict__ part, const float* __restrict__ part_e,
             const long long* __restrict__ part_skip, int n_slabs, int k,
             int d, float* __restrict__ sums, float* __restrict__ counts,
             float* __restrict__ energy, long long* __restrict__ skipped) {
  const int r = blockIdx.y;
  const int64_t per = (int64_t)k * (d + 1);
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e > per + 1) return;
  if (e == per) {
    if (!part_e) return;
    float s = 0.f;
    for (int p = 0; p < n_slabs; ++p) s += part_e[(int64_t)r * n_slabs + p];
    energy[r] = s;
    return;
  }
  if (e == per + 1) {
    if (!part_skip) return;
    long long s = 0;
    for (int p = 0; p < n_slabs; ++p) s += part_skip[(int64_t)r * n_slabs + p];
    skipped[r] = s;
    return;
  }
  const float* src = part + (int64_t)r * n_slabs * per + e;
  float s = 0.f;
  for (int p = 0; p < n_slabs; ++p) s += src[(int64_t)p * per];
  const int64_t kk = e / (d + 1);
  const int col = (int)(e - kk * (d + 1));
  if (col < d)
    sums[((int64_t)r * k + kk) * d + col] = s;
  else
    counts[(int64_t)r * k + kk] = s;
}

__host__ inline cudaError_t launch_reduce_slabs(
    cudaStream_t s, int r, const float* part, const float* part_e,
    const long long* part_skip, int n_slabs, int k, int d, float* sums,
    float* counts, float* energy, long long* skipped) {
  const int64_t elems = (int64_t)k * (d + 1) + 2;
  reduce_slabs<<<dim3((unsigned)((elems + kThreads - 1) / kThreads), r),
                 kThreads, 0, s>>>(part, part_e, part_skip, n_slabs, k, d,
                                   sums, counts, energy, skipped);
  return cudaGetLastError();
}

}  // namespace repro
