// Weighted segment sum (the Update half of a Lloyd step) for Hopper over a
// float32 X: the kernel of update.cu, shared with the fused kernels, which
// add the stats of the labels their sweep has just written (fused_lloyd.cu).
// The design is update.cu's (see there); launch_segment_sum launches it
// and the slab reduction with the layout of tiles.update_layout.  A
// bfloat16 X takes segment_sum_bf16.cuh's kernel instead, which keeps
// this kernel's slabs and order of additions, so it equals this kernel on
// the upcast X bit for bit; launch_stats (there) picks by X's type.
#pragma once

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
  int64_t w_rstride;   // floats between problems' weights (0: shared)
  int groups, width, warps, ranges, range_k, slabs, tiles_per_slab;
  int align;           // elements from X's base back to a 16-byte boundary
  int64_t x_elems;     // elements of X
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

// TX: X's element type (float: a bfloat16 X takes segment_sum_bf16.cuh);
// kVec of them make a 16-byte vector.
template <typename TX>
__global__ void __launch_bounds__(kUpdateWarps * 32, 1)
update_slabs(const TX* __restrict__ x, int64_t x_rstride,
             const int* __restrict__ labels, const float* __restrict__ w,
             UpdateGeom g, float* __restrict__ part) {
  constexpr int kVec = 16 / sizeof(TX);
  extern __shared__ float4 smem_raw[];
  const int cols = g.d + 1;
  const int pitch = g.width | 1;   // odd: 32 labels hit 32 banks
  const int spitch = staged_pitch(g.width);   // floats of a staged row
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

  // the staged rows first: 16-byte copies need 16-byte aligned rows.  A
  // staged row is spitch floats (4 * spitch bytes) whatever TX is.
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

  // X from its 16-byte boundary on; row i of the group starts at element
  // first + i * d, the vector that holds it at (first + i * d) & ~(kVec-1)
  const TX* xa = x - g.align;
  const int64_t first = g.align + r * x_rstride + c0;
  const int nvec = cdiv(xcols + kVec - 1, kVec);
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
        const int64_t at =
            ((first + (row0 + i) * g.d) & ~(int64_t)(kVec - 1)) + kVec * v;
        // past the end of X: zeros (those elements are never read)
        const int64_t left = g.align + g.x_elems - at;
        const int bytes = left >= kVec ? 16
                          : left > 0 ? (int)sizeof(TX) * (int)left : 0;
        cp_async16(xb + i * spitch + 4 * v, bytes ? xa + at : xa, bytes);
      }
      for (int i = threadIdx.x; i < kUpdateRows; i += nthreads) {
        int* lb = ls + b * kUpdateRows + i;
        float* wb = ws + b * kUpdateRows + i;
        if (i >= rows) {
          *lb = -1;
        } else {
          cp_async4(lb, lr + row0 + i);
          if (w) cp_async4(wb, w + r * g.w_rstride + row0 + i); else *wb = 1.f;
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
      const TX* xi = reinterpret_cast<const TX*>(xb + i * spitch) +
                     (int)((first + (row0 + i) * g.d) & (kVec - 1));
      float* cell = acc + (size_t)(cl < 0 ? 0 : cl) * pitch;
      // the warp's columns j = warp + u * warps, kUpdateBatch at a time:
      // values, then the leader's sums of its peers in lane order, then
      // the partials read, then written
      for (int j0 = warp; j0 < wd; j0 += kUpdateBatch * g.warps) {
        float v[kUpdateBatch], sum[kUpdateBatch];
#pragma unroll
        for (int u = 0; u < kUpdateBatch; ++u) {
          const int j = j0 + u * g.warps;
          v[u] = j < xcols ? wi * to_f32(xi[j]) : wi;
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


// Layout of a launch, as tiles.update_layout (float32 X) or
// tiles.update_bf16_layout (bfloat16 X) gives it: column groups, widest
// group, warps, cluster ranges, clusters per range, slabs, tiles per slab,
// shared bytes per block, ring slots (read by the bf16 kernel alone).
struct UpdateLayout {
  int groups, width, warps, ranges, range_k, slabs, tiles_per_slab, smem,
      stages;
};

// The segment sum of labels (R, N) over a float32 X (x_rstride elements
// between problems) and weights (none, or per row with w_rstride floats
// between problems) into part (R * slabs * K * (d+1) floats), then sums
// (R, K, d) and counts (R, K) in slab order, on stream s.  Returns the
// first CUDA error.
__host__ inline cudaError_t launch_segment_sum(
    cudaStream_t s, const float* x, int64_t x_rstride, const int* labels,
    const float* w, int64_t w_rstride, int r, int n, int k, int d,
    const UpdateLayout& lay, float* part, float* sums, float* counts) {
  if (lay.smem != update_smem(lay.width, lay.range_k) ||
      lay.smem > kUpdateSmem || lay.warps < 1 || lay.warps > kUpdateWarps)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % sizeof(float) != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = set_smem(update_slabs<float>, (size_t)lay.smem);
  if (err != cudaSuccess) return err;
  const int align =
      (int)(reinterpret_cast<uintptr_t>(x) % 16 / sizeof(float));
  const int64_t x_elems = x_rstride ? (int64_t)r * x_rstride : (int64_t)n * d;
  const UpdateGeom g{n, k, d, w_rstride, lay.groups, lay.width, lay.warps,
                     lay.ranges, lay.range_k, lay.slabs, lay.tiles_per_slab,
                     align, x_elems};
  update_slabs<float><<<dim3((unsigned)lay.slabs * lay.ranges * lay.groups,
                             r),
                        lay.warps * 32, lay.smem, s>>>(x, x_rstride, labels,
                                                       w, g, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_slabs(s, r, part, lay.slabs, k, d, sums, counts);
}

}  // namespace repro

using namespace repro;

// The layout's geometry, which tiles.update_layout takes from here: rows
// per tile, ring slots, most warps, shared bytes per block.
extern "C" void update_geometry(int* out) {
  out[0] = kUpdateRows;
  out[1] = kUpdateStages;
  out[2] = kUpdateWarps;
  out[3] = kUpdateSmem;
}
