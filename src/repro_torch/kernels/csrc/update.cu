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
// What bounds it on this card: bytes.  X, the labels and the weights are
// read once, (N*d + 2N)*4 bytes: 0.7 GB, 0.21 ms at 3.35 TB/s at N = 2.46 M,
// d = 69; the work is one multiply-add per element.  (The TPU computes a
// one-hot matmul on the MXU, 2*N*K*d operations that the MXU hides; on
// this card that would be K times the work.)  The design keeps every
// thread busy, every read-modify-write in shared memory and enough bytes
// in flight to stream X:
//   * block (slab, range, group, r) owns a fixed contiguous slab of row
//     tiles, a range of clusters and a group of the d+1 output columns
//     (column d is the weight total); its (clusters, columns) f32 partial
//     lives in shared memory.  One block of up to 16 warps runs on each SM,
//     so the partial can be wide (two groups of 35 columns at K = 1000,
//     each reading its own columns of X) and cluster ranges are needed
//     only where K is too large for a group of one column per warp
//     (tiles.update_layout);
//   * a three-slot cp.async ring stages 128-row tiles of the group's
//     columns, with their labels and weights: while a tile is added, the
//     next has landed and the one after is in flight.  128 rows, not 64,
//     halve how often a block pays its fixed cost per tile (a barrier and
//     the peers' search).  A row of d = 69 floats is 276 bytes, not
//     16-byte aligned, so each row's columns are copied as the 16-byte
//     vectors that cover them (zero-filled past the end of X) and read at
//     their offset in the first vector: a quarter of the copy
//     instructions that 4-byte copies take;
//   * each warp owns a fixed subset of the group's columns; its lanes take
//     32 consecutive rows.  __match_any_sync on the labels, once per
//     32-row group and tile (by the last warps, a tile ahead), gives each
//     lane its peers; the lowest peer sums the peers' values in lane order and
//     alone adds the result into partial[label][column].  No two warps
//     write one cell and row groups go in order, so the order of every
//     addition depends on the data alone: no atomics, and a relaunch is
//     bitwise equal;
//   * each block writes its partial once to (R, slabs, K, d+1) in device
//     memory, sized to stay inside the L2, and `reduce_slabs` (stats.cuh)
//     sums the slabs in slab order.

#include "async_copy.cuh"
#include "stats.cuh"

namespace repro {

constexpr int kUpdateRows = 128;         // rows per staged tile
constexpr int kUpdateStages = 3;         // slots of the staging ring
constexpr int kUpdateWarps = 16;         // most warps a block runs
constexpr int kUpdateSmem = 228352;      // shared bytes per block: one per SM
constexpr int kUpdateBatch = 4;          // columns a warp adds at once

struct UpdateGeom {
  int n, k, d;
  int groups, width, warps, ranges, range_k, slabs, tiles_per_slab;
  int align;           // floats from X's base back to a 16-byte boundary
  int64_t x_floats;    // floats of X
};

// Floats of one staged row of a group `width` columns wide: the 16-byte
// vectors that cover the columns from any alignment, plus 4 so that rows
// start 4 mod 8 floats apart.
__host__ __device__ inline int staged_pitch(int width) {
  return 4 * cdiv(width + 3, 4) + 4 * (cdiv(width + 3, 4) % 2 == 0);
}

// Shared bytes of a block: per ring slot the staged rows; the
// (range_k, width | 1) partial; per ring slot the rows' labels and
// weights; three words per row of two tiles for the rows' peers
// (tiles.update_smem_bytes).
__host__ inline int update_smem(int width, int range_k) {
  return 4 * (range_k * (width | 1) +
              kUpdateStages * kUpdateRows * (staged_pitch(width) + 2) +
              6 * kUpdateRows);
}

__global__ void __launch_bounds__(kUpdateWarps * 32, 1)
update_slabs(const float* __restrict__ x, int64_t x_rstride,
             const int* __restrict__ labels, const float* __restrict__ w,
             UpdateGeom g, float* __restrict__ part) {
  extern __shared__ float4 smem_raw[];
  const int cols = g.d + 1;
  const int pitch = g.width | 1;   // odd: 32 labels hit 32 banks
  const int spitch = staged_pitch(g.width);
  const int grp = blockIdx.x % g.groups;
  const int q = blockIdx.x / g.groups % g.ranges;
  const int slab = blockIdx.x / (g.groups * g.ranges);
  const int r = blockIdx.y;
  const int c0 = (int)((int64_t)grp * cols / g.groups);
  const int wd = (int)((int64_t)(grp + 1) * cols / g.groups) - c0;
  const int xcols = min(c0 + wd, g.d) - c0;  // the group's columns of X
  const int k0 = q * g.range_k, k1 = min(k0 + g.range_k, g.k);
  const int nthreads = g.warps * 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the staged rows first: 16-byte copies need 16-byte aligned rows
  float* xs = reinterpret_cast<float*>(smem_raw);     // stages x (rows, spitch)
  float* acc = xs + kUpdateStages * kUpdateRows * spitch;    // (k1 - k0, pitch)
  float* ws = acc + (size_t)g.range_k * pitch;         // stages x rows
  int* ls = reinterpret_cast<int*>(ws + kUpdateStages * kUpdateRows);
  // each row's peers, for two tiles: the peers above a leading lane (0
  // for the others), the leader's cluster offset (-1 for the others) and
  // the most peers any leader of its 32-row group sums
  unsigned* im = reinterpret_cast<unsigned*>(ls + kUpdateStages * kUpdateRows);
  int* ic = reinterpret_cast<int*>(im + 2 * kUpdateRows);
  unsigned* ie = reinterpret_cast<unsigned*>(ic + 2 * kUpdateRows);

  for (int e = threadIdx.x; e < (k1 - k0) * pitch; e += nthreads) acc[e] = 0.f;

  // X from its 16-byte boundary on; row i of the group starts at float
  // first + i * d, the vector that holds it at (first + i * d) & ~3
  const float* xa = x - g.align;
  const int64_t first = g.align + r * x_rstride + c0;
  const int nvec = cdiv(xcols + 3, 4);
  const int* lr = labels + (int64_t)r * g.n;
  const int n_tiles = cdiv(g.n, kUpdateRows);
  const int t0 = slab * g.tiles_per_slab;
  const int t1 = min(t0 + g.tiles_per_slab, n_tiles);

  // Start the copies of tile t into its ring slot and commit them as one
  // group (an empty group past the slab, so that every thread commits one
  // group per tile); rows past N get label -1.
  auto stage = [&](int t) {
    if (t < t1) {
      const int b = (t - t0) % kUpdateStages;
      const int64_t row0 = (int64_t)t * kUpdateRows;
      const int rows = (int)min((int64_t)kUpdateRows, g.n - row0);
      float* xb = xs + b * kUpdateRows * spitch;
      for (int e = threadIdx.x; e < rows * nvec; e += nthreads) {
        const int i = e / nvec, v = e - i * nvec;
        const int64_t at = ((first + (row0 + i) * g.d) & ~3LL) + 4 * v;
        // past the end of X: zeros (those floats are never read)
        const int64_t left = g.align + g.x_floats - at;
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
        cp_async16(xb + i * spitch + 4 * v, bytes ? xa + at : xa, bytes);
      }
      for (int i = threadIdx.x; i < kUpdateRows; i += nthreads) {
        int* lb = ls + b * kUpdateRows + i;
        float* wb = ws + b * kUpdateRows + i;
        if (i >= rows) {
          *lb = -1;
        } else {
          cp_async4(lb, lr + row0 + i);
          if (w) cp_async4(wb, w + row0 + i); else *wb = 1.f;
        }
      }
    }
    cp_async_commit();
  };

  // The peers of tile t's rows, once per 32-row group (its labels must be
  // visible): __match_any_sync gives each lane the lanes of its label, and
  // the lowest of them leads.  The last warps do it: the first ones own
  // the extra columns where the warps do not divide the group.
  auto match = [&](int t) {
    if (t >= t1) return;
    const int b = (t - t0) % kUpdateStages;
    for (int rg = g.warps - 1 - warp; rg >= 0 && rg < kUpdateRows / 32;
         rg += g.warps) {
      const int i = rg * 32 + lane, o = (t - t0) % 2 * kUpdateRows + i;
      const int lab = ls[b * kUpdateRows + i];
      const bool valid = lab >= k0 && lab < k1;   // [k0, k1) lies in [0, K)
      const unsigned peers = __match_any_sync(0xffffffffu, valid ? lab : -1);
      const bool lead = valid && (peers & ((1u << lane) - 1u)) == 0u;
      const unsigned mask = lead ? peers & ~((2u << lane) - 1u) : 0u;
      im[o] = mask;
      ic[o] = lead ? lab - k0 : -1;
      ie[o] = __reduce_max_sync(0xffffffffu, (unsigned)__popc(mask));
    }
  };

  for (int s = 0; s < kUpdateStages - 1; ++s) stage(t0 + s);
  cp_async_wait<kUpdateStages - 2>();        // tile t0 has landed
  __syncthreads();
  match(t0);
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kUpdateStages - 3>();      // tiles t and t + 1 have landed
    __syncthreads();        // and tile t's peers are known; slot t-1 is free
    stage(t + kUpdateStages - 1);
    match(t + 1);           // into the peers of tile t - 1, consumed
    const int b = (t - t0) % kUpdateStages;
    const float* xb = xs + b * kUpdateRows * spitch;
    const int64_t row0 = (int64_t)t * kUpdateRows;
#pragma unroll
    for (int rg = 0; rg < kUpdateRows; rg += 32) {
      const int i = rg + lane, o = (t - t0) % 2 * kUpdateRows + i;
      const unsigned mask = im[o], extra = ie[o];
      const int cl = ic[o];
      const float wi = ws[b * kUpdateRows + i];
      const float* xi = xb + i * spitch +
                        (int)((first + (row0 + i) * g.d) & 3);
      float* cell = acc + (size_t)(cl < 0 ? 0 : cl) * pitch;
      // the warp's columns j = warp + u * warps, kUpdateBatch at a time:
      // values, then the leader's sums of its peers in lane order, then
      // the partials read, then written
      for (int j0 = warp; j0 < wd; j0 += kUpdateBatch * g.warps) {
        float v[kUpdateBatch], sum[kUpdateBatch];
#pragma unroll
        for (int u = 0; u < kUpdateBatch; ++u) {
          const int j = j0 + u * g.warps;
          v[u] = j < xcols ? wi * xi[j] : wi;
          sum[u] = v[u];
        }
        unsigned rest = mask;
        for (unsigned it = 0; it < extra; ++it) {
          const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
          for (int u = 0; u < kUpdateBatch; ++u) {
            const float peer = __shfl_sync(0xffffffffu, v[u], src);
            if (rest) sum[u] += peer;
          }
          rest &= rest - 1u;
        }
        if (cl >= 0) {
          float old[kUpdateBatch];
#pragma unroll
          for (int u = 0; u < kUpdateBatch; ++u)
            if (j0 + u * g.warps < wd) old[u] = cell[j0 + u * g.warps];
#pragma unroll
          for (int u = 0; u < kUpdateBatch; ++u)
            if (j0 + u * g.warps < wd) cell[j0 + u * g.warps] = old[u] + sum[u];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* pr = part + ((int64_t)r * g.slabs + slab) * g.k * cols;
  for (int e = threadIdx.x; e < (k1 - k0) * wd; e += nthreads) {
    const int kk = e / wd, j = e - kk * wd;
    pr[(int64_t)(k0 + kk) * cols + c0 + j] = acc[kk * pitch + j];
  }
}

}  // namespace repro

using namespace repro;

// Launches the two kernels on `stream` with the layout of
// tiles.update_layout.  Pointers are device pointers; w may be null (every
// weight 1).  x_rstride is the element offset between problems (0 when X
// is shared).  part (R*slabs*K*(d+1) floats) is scratch.  Returns the first
// CUDA error (0 on success); nothing synchronises.
extern "C" int update_launch(const void* x, long long x_rstride,
                             const void* labels, const void* w, int r, int n,
                             int k, int d, int groups, int width, int warps,
                             int ranges, int range_k, int slabs,
                             int tiles_per_slab, int smem, void* part,
                             void* sums, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem != update_smem(width, range_k) || smem > kUpdateSmem ||
      warps < 1 || warps > kUpdateWarps)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(update_slabs, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const int align = (int)(reinterpret_cast<uintptr_t>(x) % 16 / 4);
  const int64_t x_floats = x_rstride ? (int64_t)r * x_rstride : (int64_t)n * d;
  const UpdateGeom g{n, k, d, groups, width, warps, ranges, range_k, slabs,
                     tiles_per_slab, align, x_floats};
  update_slabs<<<dim3((unsigned)slabs * ranges * groups, r), warps * 32,
                 smem, s>>>(
      static_cast<const float*>(x), x_rstride, static_cast<const int*>(labels),
      static_cast<const float*>(w), g, static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce_slabs(s, r, static_cast<const float*>(part),
                                  nullptr, nullptr, slabs, k, d,
                                  static_cast<float*>(sums),
                                  static_cast<float*>(counts), nullptr,
                                  nullptr);
}

// The layout's geometry, which tiles.update_layout takes from here: rows
// per tile, ring slots, most warps, shared bytes per block.
extern "C" void update_geometry(int* out) {
  out[0] = kUpdateRows;
  out[1] = kUpdateStages;
  out[2] = kUpdateWarps;
  out[3] = kUpdateSmem;
}

extern "C" const char* update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
