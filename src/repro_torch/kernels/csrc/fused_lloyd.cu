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
// Determinism.  The TPU kernel folds the stats serially over row tiles
// (":98-120", "arbitrary" grid axis).  GPU blocks run in no order, and
// float atomics would change the low bits of the sums and the energy from
// run to run, which can flip the solver's accept test e_t < e_prev near
// convergence.  So there are no atomics:
//   1. kernel `fused_step`: block (slab, r) owns a fixed contiguous slab of
//      row tiles and its own partial stats (K, d+1) in device memory.  It
//      zeroes them, then for each tile, after the nearest-centroid sweep,
//      the threads take one column each and add the tile's rows into the
//      partials in a fixed order; thread 0 keeps the slab's energy.
//   2. kernel `reduce_slabs`: each (cluster, column) sums its partials in
//      slab order.
// Same inputs, same launch config -> bitwise the same outputs.  The slab
// count P is chosen by the wrapper (tiles.slab_layout, in units of
// fused_lloyd_tile_rows() rows) so that R*P*K*(d+1)*4 bytes
// of partials stay modest (74 MB at K = 1000, d = 69, P = 264).

#include "nearest.cuh"

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
  const int dp1 = d + 1;
  const float* xr = x + r * x_rstride;
  const float* cr = c + (int64_t)r * k * d;
  const float* csqr = csq + (int64_t)r * k;
  const float* wr = w ? w + r * w_rstride : nullptr;
  int* lab_out = labels + (int64_t)r * n;
  float* mind_out = mind + (int64_t)r * n;
  float* pr = part + ((int64_t)r * n_slabs + slab) * k * dp1;

  for (int64_t e = threadIdx.x; e < (int64_t)k * dp1; e += kThreads) pr[e] = 0.f;

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

    if (threadIdx.x < rows) {
      lab_out[row0 + threadIdx.x] = sm.lab[threadIdx.x];
      mind_out[row0 + threadIdx.x] = sm.mind[threadIdx.x];
    }
    if (threadIdx.x < 32) {                 // tile energy: fixed shuffle tree
      float s = 0.f;
      for (int i = threadIdx.x; i < rows; i += 32) s += sm.w[i] * sm.mind[i];
      for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      energy += s;
    }
    // Weighted one-hot stats: one thread per column, the tile's rows in
    // groups of eight.  Rows of a group that share a label are summed
    // first, in row order; then each distinct label's partial is read and
    // written back once, so up to eight reads are in flight instead of
    // one.  The order of every addition is fixed by the data alone.
    for (int col = threadIdx.x; col < dp1; col += kThreads) {
      const float* xcol = sm.xs + (size_t)col * kXLd;
      for (int i0 = 0; i0 < rows; i0 += 8) {
        int l[8];
        float v[8], p[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + j;
          l[j] = i < rows ? sm.lab[i] : -1;
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
  if (threadIdx.x == 0) part_e[(int64_t)r * n_slabs + slab] = energy;
}

// sums (R, K, d), counts (R, K) and energy (R,) from the partials, each
// summed over slabs in slab order.  Element k*(d+1) of problem r is its
// energy.
__global__ void __launch_bounds__(kThreads)
reduce_slabs(const float* __restrict__ part, const float* __restrict__ part_e,
             int n_slabs, int k, int d, float* __restrict__ sums,
             float* __restrict__ counts, float* __restrict__ energy) {
  const int r = blockIdx.y;
  const int64_t per = (int64_t)k * (d + 1);
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e > per) return;
  if (e == per) {
    float s = 0.f;
    for (int p = 0; p < n_slabs; ++p) s += part_e[(int64_t)r * n_slabs + p];
    energy[r] = s;
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

  const int64_t per = (int64_t)k * (d + 1) + 1;
  reduce_slabs<<<dim3((unsigned)((per + kThreads - 1) / kThreads), r), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(part_e),
      n_slabs, k, d, static_cast<float*>(sums), static_cast<float*>(counts),
      static_cast<float*>(energy));
  return (int)cudaGetLastError();
}

extern "C" int fused_lloyd_max_features(int device) {
  return max_features(device);
}

// Rows per tile: the unit the wrapper's slab layout counts in.
extern "C" int fused_lloyd_tile_rows() { return kTN; }

extern "C" const char* fused_lloyd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
