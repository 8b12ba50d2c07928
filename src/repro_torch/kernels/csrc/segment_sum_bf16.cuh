// Weighted segment sum over a bfloat16 X, for Hopper (sm_90a): the bf16
// route of the update kernel (update.cu) and the stats half of every fused
// or bounded step whose X is bf16 (fused_lloyd.cu, fused_bounds.cu).
//
// Replaces, for a bf16 X, the TPU kernel
// src/repro/kernels/update.py::_update_kernel (pl.pallas_call at :80).
// What bounds it on this card: bytes.  X is read once at 2 bytes an
// element, the labels and weights at 4: 0.104 ms at 2,458,285 x 69 and
// 0.315 ms at 128,256 x 4096 at 3.35 TB/s.
//
// The contract is the f32 kernel's bits (segment_sum.cuh's update_slabs
// on the upcast X): every output cell (r, k, j) is summed in its order.
// The rows are cut into the f32 layout's slabs; within a slab the 32-row
// groups come in row order; for each label of a group the first row gives
// v = w * x (rounded), the group's later rows of that label are added to v
// in row order, and v is added to the slab's partial; reduce_slabs
// (stats.cuh) adds the slabs in slab order.  Column groups, cluster ranges,
// warps, the staging and how a group's sums are formed are free, so this
// kernel chooses its own (tiles.update_bf16_layout):
//   * block (slab, range, group, r) keeps its (clusters, columns) f32
//     partial in shared memory, as update_slabs does, beside a ring of up
//     to kMaxStages 128-row tiles staged by cp.async at 2 bytes an element
//     (16-byte vectors covering the group's columns from any alignment,
//     an odd number of vectors a row), with their labels and weights.  The
//     ring keeps stages - 2 tiles in flight while a tile is summed (the f32
//     kernel keeps one), and the layout sizes the column groups so that the
//     f32 layout's slabs fill one wave of 132 blocks;
//   * a tile ahead, the last warps order each 32-row group's rows by label:
//     __match_any_sync finds a row's peers, and a scan over the leaders
//     gives each label a contiguous run of positions, in order of first
//     appearance, its rows in row order.  A position holds the row's
//     staged offset, its label, its weight and whether it opens or closes
//     its run.  Both sweeps below read the groups in this order, so each
//     label's sum is formed in row order from its first row;
//   * by columns (groups of kColumnWidth columns or more, and any tile
//     where a group has a label on more than kRowPeers + 1 rows: sorted
//     labels): lane j of warp c owns column 32 c + j and walks a group's
//     positions, adding each run in a register and its total into the
//     partial where the run closes.  A warp reads 32 consecutive
//     elements of a row and of a partial row: no bank conflict, no idle
//     lane on long runs, one read-modify-write a run.  It reads eight
//     positions at a time, the next eight before it updates the partial
//     for these;
//   * by rows (narrower groups with scattered labels): lane p takes
//     position p of the group and each warp a share of the columns; the
//     lane that opens a run adds its run's values, shuffled down from the
//     lanes that follow it, and alone updates the partial.  A warp reads
//     its values of the tile's four groups before it updates the partial
//     group by group, and the last four warps order the next tile
//     meanwhile; every lane of the other warps works where the labels
//     differ;
//   * a tile is summed wholly in one way, chosen from its groups' longest
//     runs (uniform in the block); the barrier that starts each tile
//     separates the two ways' column owners.  No two lanes write one cell
//     at once and groups go in order, so the order of every addition is
//     the data's alone: no atomics, and a relaunch is bitwise equal.
// Products and sums are __fmul_rn / __fadd_rn, so nothing contracts into
// an FMA that the f32 kernel does not form.
#pragma once

#include <type_traits>

#include "segment_sum.cuh"

namespace repro {
namespace sum16 {

constexpr int kRows = 128;           // rows per staged tile: the slab unit
constexpr int kMinStages = 3;        // fewest ring slots
constexpr int kMaxStages = 8;        // most ring slots
constexpr int kWarps = 16;           // most warps a block runs
constexpr int kSmem = 228352;        // shared bytes per block: one per SM
constexpr int kColumnWidth = 64;     // groups this wide always sum by columns
constexpr int kRowPeers = 3;         // most peers a row-wise tile's rows have
constexpr int kGroups = kRows / 32;  // 32-row groups per tile
constexpr int kBatch = 4;            // columns a warp adds at once by rows

// A position's word: the row's staged byte offset, its run's length - 1,
// whether it opens and whether it closes its run.
constexpr unsigned kOffMask = 0xFFFFFu;
constexpr int kSizeShift = 20;
constexpr unsigned kOpens = 1u << 25;
constexpr unsigned kCloses = 1u << 26;

// Bytes of one staged row of a group `width` columns wide: the 16-byte
// vectors that cover the columns from any alignment, an odd number of them
// so that the rows of a group spread over the banks.
__host__ __device__ inline int staged_pitch(int width) {
  const int q = cdiv(width + 7, 8);
  return 16 * (q + (q % 2 == 0));
}

// Where row i of a staged tile starts: i * pitch, and 16 bytes more for
// each 8-row block of its 32-row group (48 more for each earlier group),
// so that rows 8 apart, whose columns sit at the same offset in their
// vectors, fall in different banks.
__host__ __device__ inline int staged_row(int i, int pitch) {
  return i * pitch + 16 * (((i >> 3) & 3) + 3 * (i >> 5));
}

// Bytes of one ring slot: a staged tile and its rows' shifts.
__host__ __device__ inline int staged_tile(int width) {
  return kRows * staged_pitch(width) + 16 * 3 * kGroups;
}

// Shared bytes of a block (tiles.update_bf16_smem_bytes): the ring's staged
// tiles with their labels and weights; the positions of two tiles (word,
// label, weight); two tiles' longest runs; the (range_k, width | 1)
// partial.
__host__ __device__ inline int smem_bytes(int width, int range_k,
                                          int stages) {
  return stages * (staged_tile(width) + 8 * kRows) + 2 * kRows * 12 +
         2 * kGroups * 4 + 4 * range_k * (width | 1);
}

struct Geom {
  int n, k, d;
  int64_t x_rstride;   // elements between problems' X (0: shared)
  int64_t w_rstride;   // floats between problems' weights (0: shared)
  int groups, width, warps, ranges, range_k, slabs, tiles_per_slab, stages;
  int align;           // elements from X's base back to a 16-byte boundary
  int64_t x_elems;     // elements of X
};

// The element at byte p of a staged row, as f32 (exact).
__device__ __forceinline__ float staged(const unsigned char* p) {
  return __uint_as_float(
      (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}

// Wait until at most `pending` committed copy groups are in flight (the
// ring's depth is the layout's).
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;   // kMaxStages - 2
  }
}

__global__ void __launch_bounds__(kWarps * 32, 1)
slabs(const __nv_bfloat16* __restrict__ x, const int* __restrict__ labels,
      const float* __restrict__ w, Geom g, float* __restrict__ part) {
  extern __shared__ float4 smem_raw[];
  const int pitch = staged_pitch(g.width);
  const int slot = staged_tile(g.width);
  unsigned char* const ring = reinterpret_cast<unsigned char*>(smem_raw);
  unsigned* const pword = reinterpret_cast<unsigned*>(ring + g.stages * slot);
  int* const plab = reinterpret_cast<int*>(pword + 2 * kRows);
  float* const pw = reinterpret_cast<float*>(plab + 2 * kRows);
  int* const ls = reinterpret_cast<int*>(pw + 2 * kRows);   // stages x rows
  float* const ws = reinterpret_cast<float*>(ls + g.stages * kRows);
  int* const most = reinterpret_cast<int*>(ws + g.stages * kRows);
  float* const acc = reinterpret_cast<float*>(most + 2 * kGroups);

  const int cols = g.d + 1;
  const int apitch = g.width | 1;
  const int grp = blockIdx.x % g.groups;
  const int q = blockIdx.x / g.groups % g.ranges;
  const int slab = blockIdx.x / (g.groups * g.ranges);
  const int r = blockIdx.y;
  const int c0 = (int)((int64_t)grp * cols / g.groups);
  const int wd = (int)((int64_t)(grp + 1) * cols / g.groups) - c0;
  const int xcols = min(c0 + wd, g.d) - c0;   // the group's columns of X
  const int k0 = q * g.range_k, k1 = min(k0 + g.range_k, g.k);
  const int nthreads = g.warps * 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warps that sum by rows: all but the last kGroups, which order the
  // next tile, where the block has 8 warps or more
  const int rw = g.warps >= 2 * kGroups ? g.warps - kGroups : g.warps;

  for (int e = threadIdx.x; e < (k1 - k0) * apitch; e += nthreads)
    acc[e] = 0.f;

  // X from its 16-byte boundary on; row i of the group starts at element
  // first + i * d, in the vector at (first + i * d) & ~7
  const __nv_bfloat16* xa = x - g.align;
  const int64_t first = g.align + r * g.x_rstride + c0;
  const int nvec = xcols > 0 ? cdiv(xcols + 7, 8) : 0;
  const int* lr = labels + (int64_t)r * g.n;
  const float* wr = w ? w + r * g.w_rstride : nullptr;
  const int n_tiles = cdiv(g.n, kRows);
  const int t0 = slab * g.tiles_per_slab;
  const int t1 = min(t0 + g.tiles_per_slab, n_tiles);

  // Start the copies of tile t into its ring slot and commit them as one
  // group (an empty group past the slab, so that every thread commits one
  // group per tile); rows past N get label -1.
  auto stage = [&](int t) {
    if (t < t1) {
      const int b = (t - t0) % g.stages;
      const int64_t row0 = (int64_t)t * kRows;
      const int rows = (int)min((int64_t)kRows, g.n - row0);
      unsigned char* xb = ring + b * slot;
      for (int e = threadIdx.x; e < rows * nvec; e += nthreads) {
        const int i = e / nvec, v = e - i * nvec;
        const int64_t at = ((first + (row0 + i) * g.d) & ~(int64_t)7) + 8 * v;
        // past the end of X: zeros (those elements are never read)
        const int64_t left = g.align + g.x_elems - at;
        const int bytes = left >= 8 ? 16 : left > 0 ? 2 * (int)left : 0;
        cp_async16(xb + staged_row(i, pitch) + 16 * v, bytes ? xa + at : xa,
                   bytes);
      }
      for (int i = threadIdx.x; i < kRows; i += nthreads) {
        int* lb = ls + b * kRows + i;
        float* wb = ws + b * kRows + i;
        if (i >= rows) {
          *lb = -1;
        } else {
          cp_async4(lb, lr + row0 + i);
          if (wr) cp_async4(wb, wr + row0 + i); else *wb = 1.f;
        }
      }
    }
    cp_async_commit();
  };

  // The positions of tile t (its labels must be visible), one warp a
  // 32-row group, the last warps first: the rows of a label take a run of
  // positions in row order, the runs in order of their first rows; rows
  // outside [k0, k1) share one run that adds nothing.
  auto order = [&](int t) {
    if (t >= t1) return;
    const int b = (t - t0) % g.stages, tb = (t - t0) % 2;
    const int64_t row0 = (int64_t)t * kRows;
    for (int gi = g.warps - 1 - warp; gi >= 0 && gi < kGroups;
         gi += g.warps) {
      const int i = gi * 32 + lane;
      const int lab = ls[b * kRows + i];
      const bool valid = lab >= k0 && lab < k1;   // [k0, k1) lies in [0, K)
      const unsigned peers = __match_any_sync(0xffffffffu, valid ? lab : -1);
      const int leader = __ffs(peers) - 1;
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int size = __popc(peers);
      const int opened = rank == 0 ? size : 0;
      int upto = opened;   // positions of the runs opened at lanes <= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, upto, o);
        if (lane >= o) upto += y;
      }
      const int start = __shfl_sync(0xffffffffu, upto - opened, leader);
      const int p = tb * kRows + gi * 32 + start + rank;
      const int off = (int)((first + (row0 + i) * g.d) & 7);
      pword[p] = (unsigned)(staged_row(i, pitch) + 2 * off) |
                 ((unsigned)(size - 1) << kSizeShift) |
                 (rank == 0 ? kOpens : 0u) | (rank == size - 1 ? kCloses : 0u);
      plab[p] = valid ? lab - k0 : -1;
      pw[p] = ws[b * kRows + i];
      const unsigned peak =
          __reduce_max_sync(0xffffffffu, valid ? (unsigned)(size - 1) : 0u);
      if (lane == 0) most[tb * kGroups + gi] = (int)peak;
    }
  };

  // Tile t by columns: lane j of warp c owns column 32 c + j.  A chunk is
  // eight positions: their words, labels and the lane's values (w * x, or
  // w in the weight column).  The next chunk is read before this one's
  // partial cells are written, so its reads overlap the updates.
  struct Chunk {
    unsigned word[8];
    int lab[8];
    float v[8];
  };
  auto by_columns = [&](const unsigned char* xb, const unsigned* pwd,
                        const int* plb, const float* pwt, const int* peak) {
    if (warp * 32 >= wd) return;
    const int j = warp * 32 + lane;
    const bool mine = j < wd, isx = j < xcols;
    float* const col = acc + j;
    auto fetch = [&](int p, Chunk& ch) {
#pragma unroll
      for (int h = 0; h < 8; h += 4) {
        const uint4 a = *reinterpret_cast<const uint4*>(pwd + p + h);
        const int4 l = *reinterpret_cast<const int4*>(plb + p + h);
        const float4 f = *reinterpret_cast<const float4*>(pwt + p + h);
        ch.word[h] = a.x, ch.word[h + 1] = a.y, ch.word[h + 2] = a.z;
        ch.word[h + 3] = a.w;
        ch.lab[h] = l.x, ch.lab[h + 1] = l.y, ch.lab[h + 2] = l.z;
        ch.lab[h + 3] = l.w;
        ch.v[h] = f.x, ch.v[h + 1] = f.y, ch.v[h + 2] = f.z;
        ch.v[h + 3] = f.w;   // the weights, and the weight column's values
      }
      if (isx) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float xv = staged(xb + (ch.word[u] & kOffMask) + 2 * j);
          ch.v[u] = w ? __fmul_rn(ch.v[u], xv) : xv;
        }
      }
    };
    Chunk cur, nxt;
    fetch(0, cur);
    float run = 0.f;
    // a loop over the groups, four chunks unrolled in each: the whole
    // tile unrolled overflows the instruction cache
#pragma unroll 1
    for (int gi = 0; gi < kGroups; ++gi) {
      const bool lone = peak[gi] == 0;   // no label on two rows
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int next = gi * 32 + 8 * (c + 1);
        if (next < kRows) fetch(next, nxt);
        // each run in order from its first position
        float s[8];
        if (lone) {
#pragma unroll
          for (int u = 0; u < 8; ++u) s[u] = cur.v[u];
        } else {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            run = (cur.word[u] & kOpens) ? cur.v[u]
                                         : __fadd_rn(run, cur.v[u]);
            s[u] = run;
          }
        }
        float old[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (mine && (cur.word[u] & kCloses) && cur.lab[u] >= 0)
            old[u] = col[(size_t)cur.lab[u] * apitch];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (mine && (cur.word[u] & kCloses) && cur.lab[u] >= 0)
            col[(size_t)cur.lab[u] * apitch] = __fadd_rn(old[u], s[u]);
        if (next < kRows) cur = nxt;
      }
    }
  };

  // Tile t by rows: lane p takes position p, row warp c the columns
  // c + u * rw; the lane that opens a run adds the run's later values,
  // shuffled down, and alone updates the partial.  A batch's values of all
  // four groups are read first, then the groups update the partial in
  // order.  The last kGroups warps order the next tile meanwhile.
  auto by_rows = [&](const unsigned char* xb, const unsigned* pwd,
                     const int* plb, const float* pwt, const int* peak) {
    if (warp >= rw) return;
    unsigned word[kGroups];
    int lab[kGroups];
    float wv[kGroups];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      word[gi] = pwd[gi * 32 + lane];
      lab[gi] = plb[gi * 32 + lane];
      wv[gi] = pwt[gi * 32 + lane];
    }
    for (int j0 = warp; j0 < wd; j0 += kBatch * rw) {
      float v[kGroups][kBatch];
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const unsigned char* xr = xb + (word[gi] & kOffMask);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int jj = j0 + u * rw;
          v[gi][u] = wv[gi];   // the weight column (and past the group)
          if (jj < xcols) {
            const float xv = staged(xr + 2 * jj);
            v[gi][u] = w ? __fmul_rn(wv[gi], xv) : xv;
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const int extra = peak[gi];
        const int size = (int)((word[gi] >> kSizeShift) & 31u) + 1;
        float sum[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) sum[u] = v[gi][u];
        for (int e = 1; e <= extra; ++e) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const float peer = __shfl_down_sync(0xffffffffu, v[gi][u], e);
            if (e < size) sum[u] = __fadd_rn(sum[u], peer);
          }
        }
        if ((word[gi] & kOpens) && lab[gi] >= 0) {
          float* const cell = acc + (size_t)lab[gi] * apitch;
          float old[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (j0 + u * rw < wd) old[u] = cell[j0 + u * rw];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (j0 + u * rw < wd)
              cell[j0 + u * rw] = __fadd_rn(old[u], sum[u]);
        }
      }
    }
  };

  for (int s = 0; s < g.stages - 1; ++s) stage(t0 + s);
  wait_pending(g.stages - 2);          // tile t0 has landed
  __syncthreads();
  order(t0);
  for (int t = t0; t < t1; ++t) {
    wait_pending(g.stages - 3);        // tiles t and t + 1 have landed
    __syncthreads();     // and tile t's positions are known; slot t-1 is free
    stage(t + g.stages - 1);
    order(t + 1);        // into the positions of tile t - 1, consumed
    const int b = (t - t0) % g.stages, tb = (t - t0) % 2;
    const unsigned char* xb = ring + b * slot;
    const int* peak = most + tb * kGroups;
    int longest = 0;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) longest = max(longest, peak[gi]);
    if (g.width >= kColumnWidth || longest > kRowPeers)
      by_columns(xb, pword + tb * kRows, plab + tb * kRows, pw + tb * kRows,
                 peak);
    else
      by_rows(xb, pword + tb * kRows, plab + tb * kRows, pw + tb * kRows,
              peak);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* pr = part + ((int64_t)r * g.slabs + slab) * g.k * cols;
  for (int e = threadIdx.x; e < (k1 - k0) * wd; e += nthreads) {
    const int kk = e / wd, j = e - kk * wd;
    pr[(int64_t)(k0 + kk) * cols + c0 + j] = acc[kk * apitch + j];
  }
}

// The segment sum of labels (R, N) over a bf16 X (x_rstride elements
// between problems) and weights (none, or per row with w_rstride floats
// between problems) into part (R * slabs * K * (d+1) floats), then sums
// (R, K, d) and counts (R, K) in slab order, on stream s, with the layout
// of tiles.update_bf16_layout.  A layout the kernel cannot take is
// cudaErrorInvalidValue.  Returns the first CUDA error.
__host__ inline cudaError_t launch(cudaStream_t s, const __nv_bfloat16* x,
                                  int64_t x_rstride, const int* labels,
                                  const float* w, int64_t w_rstride, int r,
                                  int n, int k, int d,
                                  const UpdateLayout& lay, float* part,
                                  float* sums, float* counts) {
  if (lay.stages < kMinStages || lay.stages > kMaxStages ||
      lay.smem != smem_bytes(lay.width, lay.range_k, lay.stages) ||
      lay.smem > kSmem || lay.warps < 1 || lay.warps > kWarps ||
      cdiv(lay.width, 32) > lay.warps ||
      staged_tile(lay.width) > (int)kOffMask)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % sizeof(__nv_bfloat16) != 0)
    return cudaErrorMisalignedAddress;
  cudaError_t err = set_smem(slabs, (size_t)lay.smem);
  if (err != cudaSuccess) return err;
  const int align = (int)(reinterpret_cast<uintptr_t>(x) % 16 / 2);
  const int64_t x_elems = x_rstride ? (int64_t)r * x_rstride : (int64_t)n * d;
  const Geom g{n, k, d, x_rstride, w_rstride, lay.groups, lay.width,
               lay.warps, lay.ranges, lay.range_k, lay.slabs,
               lay.tiles_per_slab, lay.stages, align, x_elems};
  slabs<<<dim3((unsigned)lay.slabs * lay.ranges * lay.groups, r),
          lay.warps * 32, lay.smem, s>>>(x, labels, w, g, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_slabs(s, r, part, lay.slabs, k, d, sums, counts);
}

}  // namespace sum16

// The segment sum of either X type with the layout the wrapper gave for
// it: update_slabs (segment_sum.cuh) on a float32 X, sum16::slabs on a
// bfloat16 one.  Returns the first CUDA error.
template <typename TX>
__host__ inline cudaError_t launch_stats(cudaStream_t s, const TX* x,
                                         int64_t x_rstride, const int* labels,
                                         const float* w, int64_t w_rstride,
                                         int r, int n, int k, int d,
                                         const UpdateLayout& lay, float* part,
                                         float* sums, float* counts) {
  if constexpr (std::is_same<TX, __nv_bfloat16>::value)
    return sum16::launch(s, x, x_rstride, labels, w, w_rstride, r, n, k, d,
                         lay, part, sums, counts);
  else
    return launch_segment_sum(s, x, x_rstride, labels, w, w_rstride, r, n,
                              k, d, lay, part, sums, counts);
}

}  // namespace repro

// The bf16 layout's geometry, which tiles.update_bf16_layout takes from
// here: rows per tile, fewest and most ring slots, most warps, shared
// bytes per block, the width from which every tile sums by columns.
extern "C" void update_bf16_geometry(int* out) {
  out[0] = repro::sum16::kRows;
  out[1] = repro::sum16::kMinStages;
  out[2] = repro::sum16::kMaxStages;
  out[3] = repro::sum16::kWarps;
  out[4] = repro::sum16::kSmem;
  out[5] = repro::sum16::kColumnWidth;
}
