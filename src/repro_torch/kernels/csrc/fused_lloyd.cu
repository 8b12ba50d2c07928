// One Lloyd step in one pass over X, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_lloyd.py::_fused_kernel
// (pl.pallas_call at :333, wrapper fused_lloyd_pallas at :367).  For every
// row: its nearest centroid (label, unweighted squared distance); for every
// cluster: the weighted sum of its rows and their total weight; per
// problem: the energy sum(w * min distance).  Shapes: X (N, d) shared by R
// centroid sets or (R, N, d) one per set; C (R, K, d); weights none, (N,)
// or (R, N); all float32.
//
// What bounds it on this card: the cross terms, 2*N*K*d FP32 operations
// without tensor cores (67 TFLOP/s), against N*d*4 bytes of X read once
// (3.35 TB/s); at K = 1000, d = 69 the operations bound is ~150x the bytes
// bound.  The design keeps the FMA units fed from shared memory (4 x 4
// register blocks, float4 loads; see nearest.cuh) and reads X once: the
// stats gather from the X tile while it is still in shared memory.
//
// Determinism: no atomics.  Block (slab, r) owns a fixed contiguous slab
// of row tiles and adds each tile's stats into its own partials in a fixed
// order; `reduce_slabs` sums them in slab order (stats.cuh).  Same inputs,
// same launch config -> bitwise the same outputs.  R*P*K*(d+1)*4 bytes of
// partials stay modest (74 MB at K = 1000, d = 69, P = 264).

#include "stats.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
fused_step(const float* __restrict__ x, int64_t x_rstride,
           const float* __restrict__ c, const float* __restrict__ csq,
           const float* __restrict__ w, int64_t w_rstride,
           int n, int k, int d, int n_slabs, int tiles_per_slab,
           int* __restrict__ labels, float* __restrict__ mind,
           float* __restrict__ part, float* __restrict__ part_e) {
  extern __shared__ float4 smem_raw[];
  const Smem sm(reinterpret_cast<float*>(smem_raw), d);
  const int slab = blockIdx.x, r = blockIdx.y;
  const float* xr = x + r * x_rstride;
  const float* cr = c + (int64_t)r * k * d;
  const float* csqr = csq + (int64_t)r * k;
  const float* wr = w ? w + r * w_rstride : nullptr;
  int* lab_out = labels + (int64_t)r * n;
  float* mind_out = mind + (int64_t)r * n;
  float* pr = part + ((int64_t)r * n_slabs + slab) * k * (d + 1);

  zero_partials(pr, k, d);

  float energy = 0.f;                       // meaningful in thread 0
  const int tile_end = min((slab + 1) * tiles_per_slab, cdiv(n, kTN));
  for (int tile = slab * tiles_per_slab; tile < tile_end; ++tile) {
    const int64_t row0 = (int64_t)tile * kTN;
    const int rows = n - row0 < kTN ? (int)(n - row0) : kTN;
    __syncthreads();                        // last tile's stats are done
    if (threadIdx.x < kTN)
      sm.w[threadIdx.x] = threadIdx.x < rows ? (wr ? wr[row0 + threadIdx.x] : 1.f) : 0.f;
    load_x_tile(sm, xr, row0, rows, d);
    nearest_centroids(sm, cr, csqr, k, d);
    energy += emit_tile(sm, rows, k, d, lab_out + row0, mind_out + row0, pr);
  }
  if (threadIdx.x == 0) part_e[(int64_t)r * n_slabs + slab] = energy;
}

}  // namespace repro

using namespace repro;

// Launches the three kernels of one step on `stream`.  Pointers are device
// pointers; w may be null (every weight 1).  x_rstride / w_rstride are the
// element offsets between problems (0 when shared).  csq (R*K floats),
// part (R*n_slabs*K*(d+1)) and part_e (R*n_slabs) are scratch.  Returns
// the first CUDA error (0 on success); nothing synchronises.
extern "C" int fused_lloyd_launch(
    const void* x, long long x_rstride, const void* c, const void* w,
    long long w_rstride, int r, int n, int k, int d, int n_slabs,
    int tiles_per_slab, void* csq, void* labels, void* mind, void* part,
    void* part_e, void* sums, void* counts, void* energy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = (int64_t)r * k;
  row_sqnorms<<<(unsigned)((rows + 7) / 8), kThreads, 0, s>>>(
      static_cast<const float*>(c), rows, d, static_cast<float*>(csq));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes(d);
  err = set_smem(fused_step, smem);
  if (err != cudaSuccess) return (int)err;
  fused_step<<<dim3(n_slabs, r), kThreads, smem, s>>>(
      static_cast<const float*>(x), x_rstride, static_cast<const float*>(c),
      static_cast<const float*>(csq), static_cast<const float*>(w), w_rstride,
      n, k, d, n_slabs, tiles_per_slab, static_cast<int*>(labels),
      static_cast<float*>(mind), static_cast<float*>(part),
      static_cast<float*>(part_e));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  return (int)launch_reduce_slabs(
      s, r, static_cast<const float*>(part), static_cast<const float*>(part_e),
      nullptr, n_slabs, k, d, static_cast<float*>(sums),
      static_cast<float*>(counts), static_cast<float*>(energy), nullptr);
}

extern "C" int fused_lloyd_max_features(int device) {
  return max_features(device);
}

// Rows per tile: the unit the wrapper's slab layout counts in.
extern "C" int fused_lloyd_tile_rows() { return kTN; }

extern "C" const char* fused_lloyd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
