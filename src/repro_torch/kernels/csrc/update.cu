// Weighted segment sum for Hopper (sm_90a): the Update half of a Lloyd
// step for a known assignment.
//
// Replaces the TPU kernel src/repro/kernels/update.py::_update_kernel
// (pl.pallas_call at :80, wrapper update_pallas at :102).  For R label
// sets: sums[r, k] = sum of w_i * x_i over the rows labelled k, and
// counts[r, k] = sum of their w_i.  A label outside [0, K) adds nothing
// (the TPU wrapper gives its padding rows label -1).  Shapes: X (N, d)
// shared by the R label sets or (R, N, d) one per set; labels (R, N)
// int32; weights none or (N,); all float32 -> sums (R, K, d), counts
// (R, K).
//
// What bounds it on this card: memory.  X, the labels and the weights are
// read once, (N*d + 2N)*4 bytes (0.7 GB at N = 2.46 M, d = 69: 0.21 ms at
// 3.35 TB/s); the work is one add per element.  The TPU computes it as a
// one-hot matmul on the MXU, 2*N*K*d operations that the MXU hides; on
// SIMT cores that would be K times the work, so this kernel gathers
// instead.  It reuses the fused step's deterministic stats (stats.cuh):
// block (slab, r) walks a fixed slab of 64-row X tiles staged in shared
// memory and adds them into its own (K, d+1) partials, labels read rather
// than computed; `reduce_slabs` sums the partials in slab order.  No
// atomics, so a relaunch is bitwise equal.  A label-sorted segmented
// reduction would need a sort of N labels per call, a second read of X in
// sorted order and its own scratch, for the same determinism.

#include "stats.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
update_step(const float* __restrict__ x, int64_t x_rstride,
            const int* __restrict__ labels, const float* __restrict__ w,
            int n, int k, int d, int n_slabs, int tiles_per_slab,
            float* __restrict__ part) {
  extern __shared__ float4 smem_raw[];
  const Smem sm(reinterpret_cast<float*>(smem_raw), d);
  const int slab = blockIdx.x, r = blockIdx.y;
  const float* xr = x + r * x_rstride;
  const int* lr = labels + (int64_t)r * n;
  float* pr = part + ((int64_t)r * n_slabs + slab) * k * (d + 1);

  zero_partials(pr, k, d);

  const int tile_end = min((slab + 1) * tiles_per_slab, cdiv(n, kTN));
  for (int tile = slab * tiles_per_slab; tile < tile_end; ++tile) {
    const int64_t row0 = (int64_t)tile * kTN;
    const int rows = n - row0 < kTN ? (int)(n - row0) : kTN;
    __syncthreads();                        // last tile's stats are done
    if (threadIdx.x < rows) {
      sm.lab[threadIdx.x] = lr[row0 + threadIdx.x];
      sm.w[threadIdx.x] = w ? w[row0 + threadIdx.x] : 1.f;
    }
    load_x_tile(sm, xr, row0, rows, d);
    add_tile_stats(sm, rows, k, d, pr);
  }
}

}  // namespace repro

using namespace repro;

// Launches the two kernels on `stream`.  Pointers are device pointers; w
// may be null (every weight 1).  x_rstride is the element offset between
// problems (0 when X is shared).  part (R*n_slabs*K*(d+1) floats) is
// scratch.  Returns the first CUDA error (0 on success); nothing
// synchronises.
extern "C" int update_launch(const void* x, long long x_rstride,
                             const void* labels, const void* w, int r, int n,
                             int k, int d, int n_slabs, int tiles_per_slab,
                             void* part, void* sums, void* counts,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(d);
  cudaError_t err = set_smem(update_step, smem);
  if (err != cudaSuccess) return (int)err;
  update_step<<<dim3(n_slabs, r), kThreads, smem, s>>>(
      static_cast<const float*>(x), x_rstride, static_cast<const int*>(labels),
      static_cast<const float*>(w), n, k, d, n_slabs, tiles_per_slab,
      static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce_slabs(s, r, static_cast<const float*>(part),
                                  nullptr, nullptr, n_slabs, k, d,
                                  static_cast<float*>(sums),
                                  static_cast<float*>(counts), nullptr,
                                  nullptr);
}

extern "C" int update_max_features(int device) { return max_features(device); }

// Rows per tile: the unit the wrapper's slab layout counts in.
extern "C" int update_tile_rows() { return kTN; }

extern "C" const char* update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
