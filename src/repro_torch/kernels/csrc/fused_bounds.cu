// One Lloyd step in one pass over X that skips centroid groups no row of
// a tile can need, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_lloyd.py::
// _fused_bounds_kernel (pl.pallas_call at :262, launcher
// _fused_bounds_call at :224).  The fused step (fused_lloyd.cu) plus the
// bound contract of core/backends/bounds.py, in squared space: for every
// row its previous label lab0, a squared upper bound ub^2 on the distance
// to that centroid, and squared lower bounds lb^2 (N, G) on the distance
// to every centroid of each group of gs contiguous centroids.  Group g of
// a kTN-row tile is computed when any row of the tile that holds data has
// lb^2[row, g] <= ub^2[row]; otherwise the whole block skips the group's
// C loads and FMAs, and the group's lb^2 passes through as its new
// minimum.  The running min starts at (ub^2, lab0) and the seed wins a
// tie (nearest.cuh), so a row whose other groups are all skipped still
// ends at its exact label.  Outputs: the fused step's five, the squared
// group minima gmin^2 (R, N, G) (a computed group's minimum over its own
// centroids; a skipped group's lb^2, bit for bit) and the count of skipped
// (tile, group) cells per problem (R,), summed as integers.
//
// What bounds it on this card: the cross terms of the computed groups,
// (1 - skip) * 2*N*K*d FP32 operations (67 TFLOP/s), against X, the
// bounds and the group minima read or written once, (N*d + 2*N*G + 4*N)*4
// bytes (3.35 TB/s).  The sweep is the fused step's (4 x 4 register
// blocks from shared memory), visiting only the 64-centroid chunks that
// meet a computed group and prefetching the next such chunk.  The group
// size is a runtime value: a chunk may straddle groups, so centroids are
// masked by group and each group's minimum is merged across the half
// warp once, where the group ends.  Stats and energy are the fused
// step's, deterministic in the same way (stats.cuh).

#include "stats.cuh"

namespace repro {

__host__ __device__ inline int need_words(int g) { return cdiv(g, 32); }

__global__ void __launch_bounds__(kThreads)
fused_bounds_step(const float* __restrict__ x, int64_t x_rstride,
                  const float* __restrict__ c, const float* __restrict__ csq,
                  const float* __restrict__ w, int64_t w_rstride,
                  const int* __restrict__ lab0, const float* __restrict__ lb,
                  const float* __restrict__ ub, int n, int k, int d, int gs,
                  int g, int n_slabs, int tiles_per_slab,
                  int* __restrict__ labels, float* __restrict__ mind,
                  float* __restrict__ gmin, float* __restrict__ part,
                  float* __restrict__ part_e,
                  long long* __restrict__ part_skip) {
  extern __shared__ float4 smem_raw[];
  const Smem sm(reinterpret_cast<float*>(smem_raw), d);
  unsigned* need = reinterpret_cast<unsigned*>(sm.lab + kTN);
  const int slab = blockIdx.x, r = blockIdx.y;
  const float* xr = x + r * x_rstride;
  const float* cr = c + (int64_t)r * k * d;
  const float* csqr = csq + (int64_t)r * k;
  const float* wr = w ? w + r * w_rstride : nullptr;
  const int* lab0r = lab0 + (int64_t)r * n;
  const float* lbr = lb + (int64_t)r * n * g;
  const float* ubr = ub + (int64_t)r * n;
  float* gminr = gmin + (int64_t)r * n * g;
  float* pr = part + ((int64_t)r * n_slabs + slab) * k * (d + 1);

  zero_partials(pr, k, d);

  float energy = 0.f;                       // meaningful in thread 0
  long long skipped = 0;                    // meaningful in thread 0
  const int tile_end = min((slab + 1) * tiles_per_slab, cdiv(n, kTN));
  for (int tile = slab * tiles_per_slab; tile < tile_end; ++tile) {
    const int64_t row0 = (int64_t)tile * kTN;
    const int rows = n - row0 < kTN ? (int)(n - row0) : kTN;
    __syncthreads();                        // last tile is done
    if (threadIdx.x < kTN) {
      const bool real = threadIdx.x < rows;
      sm.w[threadIdx.x] = real ? (wr ? wr[row0 + threadIdx.x] : 1.f) : 0.f;
      sm.mind[threadIdx.x] = real ? ubr[row0 + threadIdx.x] : 0.f;
      sm.lab[threadIdx.x] = real ? lab0r[row0 + threadIdx.x] : 0;
    }
    for (int e = threadIdx.x; e < need_words(g); e += kThreads) need[e] = 0u;
    load_x_tile(sm, xr, row0, rows, d);     // ends with __syncthreads()

    // The skip test of every (tile, group) cell over the tile's real rows.
    const float* lbt = lbr + row0 * g;
    for (int e = threadIdx.x; e < rows * g; e += kThreads) {
      const int grp = e % g;
      if (lbt[e] <= sm.mind[e / g]) atomicOr(&need[grp >> 5], 1u << (grp & 31));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int on = 0;
      for (int q = 0; q < need_words(g); ++q) on += __popc(need[q]);
      skipped += g - on;
    }
    // A skipped group's bound passes through as its minimum.
    float* gmint = gminr + row0 * g;
    for (int e = threadIdx.x; e < rows * g; e += kThreads) {
      const int grp = e % g;
      if (!((need[grp >> 5] >> (grp & 31)) & 1u)) gmint[e] = lbt[e];
    }
    const GroupSkip skip{need, gs, g, gmint, rows};
    sweep<true>(sm, cr, csqr, k, d, skip);
    energy += emit_tile(sm, rows, k, d, labels + (int64_t)r * n + row0,
                        mind + (int64_t)r * n + row0, pr);
  }
  if (threadIdx.x == 0) {
    part_e[(int64_t)r * n_slabs + slab] = energy;
    part_skip[(int64_t)r * n_slabs + slab] = skipped;
  }
}

// Dynamic shared memory: the fused step's plus the need bits.
__host__ inline size_t bounds_smem_bytes(int d, int g) {
  return smem_bytes(d) + sizeof(unsigned) * need_words(g);
}

}  // namespace repro

using namespace repro;

// Launches the three kernels of one step on `stream`.  Pointers are device
// pointers; w may be null (every weight 1).  x_rstride / w_rstride are the
// element offsets between problems (0 when shared).  lab0 (R, N) int32,
// lb (R, N, G) and ub (R, N) float32 are the squared bounds; gmin (R, N,
// G) and skipped (R,) int64 are outputs besides the fused step's.  csq
// (R*K floats), part (R*n_slabs*K*(d+1)), part_e (R*n_slabs) and
// part_skip (R*n_slabs int64) are scratch.  Returns the first CUDA error
// (0 on success); nothing synchronises.
extern "C" int fused_bounds_launch(
    const void* x, long long x_rstride, const void* c, const void* w,
    long long w_rstride, const void* lab0, const void* lb, const void* ub,
    int r, int n, int k, int d, int gs, int g, int n_slabs,
    int tiles_per_slab, void* csq, void* labels, void* mind, void* gmin,
    void* part, void* part_e, void* part_skip, void* sums, void* counts,
    void* energy, void* skipped, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = (int64_t)r * k;
  row_sqnorms<<<(unsigned)((rows + 7) / 8), kThreads, 0, s>>>(
      static_cast<const float*>(c), rows, d, static_cast<float*>(csq));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = bounds_smem_bytes(d, g);
  err = set_smem(fused_bounds_step, smem);
  if (err != cudaSuccess) return (int)err;
  fused_bounds_step<<<dim3(n_slabs, r), kThreads, smem, s>>>(
      static_cast<const float*>(x), x_rstride, static_cast<const float*>(c),
      static_cast<const float*>(csq), static_cast<const float*>(w), w_rstride,
      static_cast<const int*>(lab0), static_cast<const float*>(lb),
      static_cast<const float*>(ub), n, k, d, gs, g, n_slabs, tiles_per_slab,
      static_cast<int*>(labels), static_cast<float*>(mind),
      static_cast<float*>(gmin), static_cast<float*>(part),
      static_cast<float*>(part_e), static_cast<long long*>(part_skip));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  return (int)launch_reduce_slabs(
      s, r, static_cast<const float*>(part), static_cast<const float*>(part_e),
      static_cast<const long long*>(part_skip), n_slabs, k, d,
      static_cast<float*>(sums), static_cast<float*>(counts),
      static_cast<float*>(energy), static_cast<long long*>(skipped));
}

// Widest d whose tile and G need bits fit the shared memory a block may
// opt in to on `device`; -1 when the device cannot be queried.
extern "C" int fused_bounds_max_features(int device, int g) {
  const int widest = max_features(device);
  if (widest < 0) return widest;
  const long long bits = (long long)sizeof(unsigned) * need_words(g);
  const long long per_col = (long long)sizeof(float) * kXLd;
  const long long room = widest - (bits + per_col - 1) / per_col;
  return room < 0 ? 0 : (int)room;
}

// Rows per tile: the unit of the slab layout and of the skip test.
extern "C" int fused_bounds_tile_rows() { return kTN; }

extern "C" const char* fused_bounds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
