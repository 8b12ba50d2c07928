// The bounded fused step's sweep past the resident X tile (rows wider than
// the tile holds, or where the launcher forces it): the streamed path of
// fused_bounds.cu, on float32, bfloat16 or mixed operands.
//
// Replaces, with fused_bounds.cu's resident path, the TPU kernel
// src/repro/kernels/fused_lloyd.py::_fused_bounds_kernel (pl.pallas_call
// at :262): one Lloyd step that skips the centroid groups no row of a
// 64-row tile can need.  For every row its previous label lab0, a squared
// upper bound ub^2 and squared lower bounds lb^2 (N, G), one a group of gs
// contiguous centroids; group g of a tile is computed when any of the
// tile's rows that hold data has lb^2[row, g] <= ub^2[row].  The running
// minimum starts at (ub^2, lab0) and the seed wins a tie (index -1 in
// nearest.cuh's order); a computed group's minimum over its own centroids,
// and a skipped group's lb^2 bit for bit, go to gmin; each tile's count of
// skipped groups to part_skip.
//
// What bounds it on this card: the cross terms of the computed groups,
// (1 - skip) * 2*N*K*d FP32 operations on the CUDA cores (67 TFLOP/s: 4.03
// ms at 128,256 x 4096, K = 256, skip 0), against X read once per chunk of
// 256 centroid slots, the bounds and the group minima (2.1 GB of X: 0.63 ms
// at 3.35 TB/s).  Split TF32 missed the kernels' 1e-5 gate
// (sweep_fp32.cuh), so the design is sweep_wide.cuh's FP32 GEMM, its
// epilogue the bounded argmin and the group minima:
//  - one block a 128-row tile, two of the skip test's 64-row tiles, of 256
//    threads: 8 rows x 16 slots of cross terms a lane, warps 4 (rows) x 2
//    (slot halves of a 256-slot chunk), so each warp's rows lie in one
//    64-row tile; warp w takes slot half w / 4, so the four warps of a
//    half sit on the SM's four sub-partitions;
//  - 32-feature stages in a three-slot ring, one block barrier a stage.
//    One thread starts each stage's TMA copies onto the slot's mbarrier:
//    X's box where its rows start 16-byte aligned (else plain loads a
//    stage ahead), and C's box of 256 slots where the block computes every
//    group.  Where a tile skips a group, the block computes the union of
//    its two tiles' groups: the 16-byte vectors of C that hold a centroid
//    of a computed group are listed a chunk at a time (Lists::fill: live
//    vectors 64c .. 64c+63 are chunk c) and copied by cp.async, so the
//    work follows the computed share at any group size and the shared
//    memory does not grow with K; a warp multiplies only the float4
//    columns of its half that hold live vectors (none when the chunk's
//    live vectors fit the other half);
//  - the |x|^2 chains, one a row, in the four warps of slot half 1;
//  - no running minimum in registers across the FMA loop: at a chunk's
//    end each lane's distances replace its cross terms, its rows' minima
//    merge over the 8 lanes of a row group by shuffles, then the two
//    halves and the running minimum through shared memory, one thread a
//    row; the group minima of the warp's tile merge the same way (a
//    group wholly inside a slot half is written by its warp, the groups
//    at a half's ends, and one that goes on into the next chunk, are
//    folded one thread a row).  For each tile's rows a group that the tile
//    skips neither competes nor writes a minimum.
//
// Numbers: the parent's.  Every cross term is one FMA chain over the
// features in increasing order from 0 (zeros past d add nothing), |x|^2
// one FMA chain a row in column order, the distance max(|x|^2 - 2 x.c +
// |c|^2, 0) with NaN passed through, the minima in nearest.cuh's total
// order (a minimum of minima in any grouping is the minimum over all), the
// group minima as keys (key_of) whose minimum is order-free.  So labels,
// distances and group minima equal the resident bounded launch bit for bit
// wherever both fit; a bf16 operand is converted to f32 where it is stored,
// so such a launch equals the f32 launch on the upcast operands.  No float
// atomics: a relaunch is bitwise equal.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "sweep_wide.cuh"

namespace repro {

namespace bwide {

using wide::kColWarps;
using wide::kCSlot;
using wide::kDepth;
using wide::kRawSlot;
using wide::kRing;
using wide::kRowWarps;
using wide::kRows;
using wide::kSlabLoads;
using wide::kSlots;
using wide::kThreads;
using wide::kWarpRows;
using wide::kWarpSlots;
using wide::kWarps;
using wide::kXLd;
constexpr int kLaneRows = wide::kLaneRows;
constexpr int kCents = wide::kCents;
constexpr int kTileRows = f8::kRows;          // rows of the skip test's tile
constexpr int kTiles = kRows / kTileRows;     // tiles a block
constexpr int kVecs = f8::kVecs;              // 16-byte vectors a chunk
constexpr int kLists = 4;                     // chunk lists in the window
constexpr int kHalfVecs = kVecs / kColWarps;  // vectors of a slot half
static_assert(kTiles == 2 && kRowWarps * kWarpRows == kRows &&
                  kTileRows % kWarpRows == 0 && kColWarps == 2 &&
                  kHalfVecs == 32 && kSlots == 16 && kWarps == 8,
              "the block's shape");

// Shared memory: slack to align the rings to 1024 bytes, the C ring, the
// raw X ring, two transposed X slabs, the ring's mbarriers, |x|^2, the
// running minima (value, index), the halves' row minima (value, index),
// the open group minima, the halves' end-group minima, the chunk lists,
// the list scan's words and the two tiles' need bits.
__host__ __device__ inline size_t smem_bytes(int g) {
  return 1024 +
         sizeof(float) * ((size_t)kRing * (kCSlot + kRawSlot) +
                          2 * kDepth * kXLd) +
         sizeof(uint64_t) * kRing +
         sizeof(float) * ((size_t)kRows + 2 * kRows + 2 * kColWarps * kRows +
                          kRows + 2 * kColWarps * kRows + kLists * kVecs +
                          kWarps + 1 + (size_t)kTiles * need_words(g));
}

// What the block computes: the union of its two tiles' groups (need: the
// tiles' bits, nw words each).  Vector v is centroids 4v .. 4v+3; it is
// live when it holds a centroid of a computed group.  Chunk c is the live
// vectors 64c .. 64c+63 in increasing order, listed into a window of
// kLists chunks, since the ring copies two stages ahead (all: every group
// is computed and vector i of chunk c is 64c + i).  f8::Skip does the same
// for one tile in a window of two; it stays apart, so that the resident
// kernel's code does not change.
struct Lists {
  const unsigned* need;   // kTiles x nw
  int nw;
  int* live;              // kLists x kVecs: chunk c at (c % kLists) * kVecs
  int* scan;              // kWarps counts, then the first vector not yet
                          // scanned
  bool all;
  int k, gs, g;

  __device__ bool computed(int grp) const {
    return ((need[grp >> 5] | need[nw + (grp >> 5)]) >> (grp & 31)) & 1u;
  }
  __device__ int vec(int c, int i) const {
    return all ? c * kVecs + i : live[(c % kLists) * kVecs + i];
  }
  __device__ bool vec_live(int v) const {
    const int g1 = (min(4 * v + 4, k) - 1) / gs;
    for (int grp = 4 * v / gs; grp <= g1; ++grp)
      if (computed(grp)) return true;
    return false;
  }
  // The first computed group with a centroid in live vector v, and the
  // last.
  __device__ int first_group(int v) const {
    int grp = 4 * v / gs;
    while (!computed(grp)) ++grp;
    return grp;
  }
  __device__ int last_group(int v) const {
    int grp = (min(4 * v + 4, k) - 1) / gs;
    while (!computed(grp)) --grp;
    return grp;
  }
  // The number of live vectors; called by every thread.
  __device__ int count() const {
    const int nv = cdiv(k, 4);
    if (all) return nv;
    int total = 0;
    for (int v0 = 0; v0 < nv; v0 += kThreads) {
      const int v = v0 + threadIdx.x;
      total += __syncthreads_count(v < nv && vec_live(v));
    }
    return total;
  }
  // Lists chunk c, the next (up to) kVecs live vectors from the cursor on:
  // a thread a vector, ranked by a ballot in its warp and the counts of the
  // warps before it.  Called by every thread, in chunk order, once chunk
  // c - kLists's list is no longer read (its first barrier comes before
  // any write); ends with __syncthreads().
  __device__ void fill(int c) const {
    if (all) return;
    const int nv = cdiv(k, 4);
    int* dst = live + (c % kLists) * kVecs;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    int got = 0, v0 = scan[kWarps];
    while (got < kVecs && v0 < nv) {
      const int v = v0 + threadIdx.x;
      const bool on = v < nv && vec_live(v);
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (lane == 0) scan[warp] = __popc(m);
      __syncthreads();
      int rank = got + __popc(m & ((1u << lane) - 1u)), total = 0;
      for (int q = 0; q < kWarps; ++q) {
        if (q < warp) rank += scan[q];
        total += scan[q];
      }
      if (on && rank < kVecs) {
        dst[rank] = v;
        if (rank == kVecs - 1) scan[kWarps] = v + 1;
      }
      __syncthreads();       // counts read and the list written
      if (got + total >= kVecs) {
        got = kVecs;
        v0 = scan[kWarps];
      } else {
        got += total;
        v0 += kThreads;
      }
    }
  }
};

// One stage's FMAs: 32 features of the lane's 8 rows (xa: its first in
// the transposed slab) against the first kQ float4 columns of its slots
// (cb: its first in the C stage), 4 features a trip, each C value meeting
// the rows in turn (sweep_wide.cuh's loop).
template <int kQ>
__device__ __forceinline__ void fma_stage(const float* __restrict__ xa,
                                          const float* __restrict__ cb,
                                          float (&acc)[kLaneRows][kSlots]) {
#pragma unroll 4
  for (int f = 0; f < kDepth; ++f) {
    float av[kLaneRows], bv[4 * kQ];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(xa + f * kXLd + 16 * h);
      av[4 * h] = a.x;
      av[4 * h + 1] = a.y;
      av[4 * h + 2] = a.z;
      av[4 * h + 3] = a.w;
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 b =
          *reinterpret_cast<const float4*>(cb + f * kCents + 32 * q);
      bv[4 * q] = b.x;
      bv[4 * q + 1] = b.y;
      bv[4 * q + 2] = b.z;
      bv[4 * q + 3] = b.w;
    }
#pragma unroll
    for (int j = 0; j < 4 * kQ; ++j)
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i)
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// One 128-row tile of X a block (blockIdx.x), one problem a grid row
// (blockIdx.y): the bounded step's labels, min distances, group minima and
// the two 64-row tiles' skipped counts (part_skip (R, cdiv(n, 64))).  cmap:
// C transposed (prepare_c's ct, as (k_pad, d, R)); csq |c|^2.  kVecGroups:
// gs and K multiples of 4, so that each vector lies in one group.  kTmaX:
// X's slabs come by TMA through xmap, else by plain loads from x.
template <bool kVecGroups, typename TX, bool kTmaX>
__global__ void __launch_bounds__(kThreads, 1)
bounds_stream(const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap xmap,
              const TX* __restrict__ x, int64_t x_rstride,
              const float* __restrict__ ct, const float* __restrict__ csq,
              const int* __restrict__ lab0, const float* __restrict__ lb,
              const float* __restrict__ ub, int n, int k, int d, int gs,
              int g, int* __restrict__ labels, float* __restrict__ mind,
              float* __restrict__ gmin, int* __restrict__ part_skip) {
  extern __shared__ float4 smem_raw[];
  const unsigned base = smem_addr(smem_raw);
  float* const cring = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem_raw) + ((1024 - base % 1024) % 1024));
  float* const raw = cring + kRing * kCSlot;
  float* const xring = raw + kRing * kRawSlot;
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(xring + 2 * kDepth * kXLd);
  float* const xsq_s = reinterpret_cast<float*>(bars + kRing);
  float* const run_v = xsq_s + kRows;
  int* const run_a = reinterpret_cast<int*>(run_v + kRows);
  float* const part_v = reinterpret_cast<float*>(run_a + kRows);
  int* const part_a = reinterpret_cast<int*>(part_v + kColWarps * kRows);
  unsigned* const open =
      reinterpret_cast<unsigned*>(part_a + kColWarps * kRows);
  // [half][end][row]: the minimum of the first (end 0) and the last (end
  // 1) computed group of a slot half
  unsigned* const ends = open + kRows;
  int* const live = reinterpret_cast<int*>(ends + 2 * kColWarps * kRows);
  int* const scan = live + kLists * kVecs;
  unsigned* const need = reinterpret_cast<unsigned*>(scan + kWarps + 1);
  const int nw = need_words(g);

  const int r = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int rows = n - row0 < kRows ? (int)(n - row0) : kRows;
  const int64_t at = (int64_t)r * n + row0;   // the block's first row
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wc = warp / kRowWarps, wr = warp % kRowWarps;
  const int ry = lane / 8, cx = lane % 8;
  // this lane's rows: wide::row_of(xrow, i); its slots of a chunk:
  // wide::slot_of(cslot0, j), float4 column q = j / 4 holding list
  // position 32 wc + cx + 8q
  const int xrow = wr * kWarpRows + ry * 4;
  const int cslot0 = wc * kWarpSlots + cx * 4;
  const unsigned* const need_w = need + (xrow / kTileRows) * nw;
  // the |x|^2 chains: the four warps of slot half 1, 32 rows each
  const bool sq = wc == 1;
  const int sq_row = wr * 32 + lane;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kRows) {
    run_v[tid] = tid < rows ? ub[at + tid] : 0.f;   // the seed (ub^2, -1)
    run_a[tid] = -1;
  }
  for (int e = tid; e < kTiles * nw; e += kThreads) need[e] = 0u;
  if (tid == 0) scan[kWarps] = 0;   // the list's cursor
  __syncthreads();

  // The skip test of every (tile, group) cell over the tiles' real rows.
  // Cell e = row * g + group of the block's rows, stepped, not divided,
  // from one pass to the next.  With G <= 32 every bit is in word 0 of
  // its tile: a warp ORs its lanes' bits first, and one lane sets them.
  const float* const lbt = lb + at * g;
  const int cells = rows * g;
  const int q_step = kThreads / g, r_step = kThreads % g;
  auto next_cell = [&](int& row, int& grp) {
    row += q_step;
    grp += r_step;
    if (grp >= g) {
      grp -= g;
      ++row;
    }
  };
  int row_t = tid / g, grp_t = tid % g;
  for (int e0 = 0; e0 < cells; e0 += kThreads) {
    const int e = e0 + tid, row = row_t, grp = grp_t;
    next_cell(row_t, grp_t);
    const bool hit = e < cells && lbt[e] <= run_v[row];
    const int t = row >= kTileRows;
    if (g <= 32) {
      const unsigned b0 =
          __reduce_or_sync(0xffffffffu, hit && t == 0 ? 1u << grp : 0u);
      const unsigned b1 =
          __reduce_or_sync(0xffffffffu, hit && t == 1 ? 1u << grp : 0u);
      if (lane == 0) {
        if (b0) atomicOr(need, b0);
        if (b1) atomicOr(need + nw, b1);
      }
    } else if (hit) {
      atomicOr(&need[t * nw + (grp >> 5)], 1u << (grp & 31));
    }
  }
  __syncthreads();
  int on0 = 0, on1 = 0, on_all = 0;   // computed groups: tiles, union
  for (int q = 0; q < nw; ++q) {
    on0 += __popc(need[q]);
    on1 += __popc(need[nw + q]);
    on_all += __popc(need[q] | need[nw + q]);
  }
  if (tid < kTiles && tid * kTileRows < rows)
    part_skip[(int64_t)r * cdiv(n, kTileRows) + kTiles * blockIdx.x + tid] =
        g - (tid ? on1 : on0);
  // A skipped cell's bound passes through as its minimum.
  float* const gmint = gmin + at * g;
  row_t = tid / g;
  grp_t = tid % g;
  for (int e0 = 0; e0 < cells; e0 += kThreads) {
    const int e = e0 + tid, row = row_t, grp = grp_t;
    next_cell(row_t, grp_t);
    if (e < cells && !bit(need + (row >= kTileRows) * nw, grp))
      gmint[e] = lbt[e];
  }

  const Lists ls{need, nw, live, scan, on_all == g, k, gs, g};
  const int total = ls.count();             // live vectors; every thread
  const int n_chunks = cdiv(total, kVecs);
  const int n_ds = cdiv(d, kDepth);
  const int n_stages = n_chunks * n_ds;
  for (int c = 0; c < kLists - 1 && c < n_chunks; ++c) ls.fill(c);
  // live vectors of chunk c
  auto chunk_vecs = [&](int c) { return min(kVecs, total - c * kVecs); };
  // float4 columns of this warp's half that hold live vectors of chunk c
  auto columns = [&](int c) {
    const int left = chunk_vecs(c) - wc * kHalfVecs;
    return left <= 0 ? 0 : min(4, cdiv(left, 8));
  };

  const TX* const xt = x + r * x_rstride + row0 * d;
  const int k_pad = f8::pad_centroids(k);
  const float* const ctr = ct + (int64_t)r * d * k_pad;
  csq += (int64_t)r * k;
  // the ring's stages: C's box where every group is computed (else the
  // live vectors by cp.async), and X's where it comes by TMA
  const bool c_tma = ls.all;
  const bool bar_used = c_tma || kTmaX;
  const uint32_t stage_bytes = (c_tma ? sizeof(float) * kCSlot : 0) +
                               (kTmaX ? sizeof(TX) * kRawSlot : 0);
  const int xr = x_rstride ? r : 0;   // X's problem coordinate
  // the next stage to copy: chunk w_kc, features w_d0 on, into slot w_slot
  int w_kc = 0, w_d0 = 0, w_slot = 0;
  auto next_stage = [&]() {
    if (w_kc == n_chunks) return;
    float* const cdst = cring + w_slot * kCSlot;
    if (bar_used && tid == 0) {
      mbar_expect(bars + w_slot, stage_bytes);
      if (c_tma) tma3(cdst, &cmap, w_kc * kCents, w_d0, r, bars + w_slot);
      if (kTmaX)
        tma3(raw + w_slot * kRawSlot, &xmap, w_d0, (int)row0, xr,
             bars + w_slot);
    }
    if (!c_tma) {
      // the chunk's live vectors, 16 bytes a feature; zero past d
      const int nv = chunk_vecs(w_kc);
      for (int e = tid; e < kDepth * kVecs; e += kThreads) {
        const int f = e / kVecs, i = e % kVecs;
        if (i < nv) {
          const bool in_d = w_d0 + f < d;
          cp_async16(cdst + f * kCents + 4 * i,
                     in_d ? ctr + (int64_t)(w_d0 + f) * k_pad +
                                4 * ls.vec(w_kc, i)
                          : ctr,
                     in_d ? 16 : 0);
        }
      }
      cp_async_commit();
    }
    w_d0 += kDepth;
    if (w_d0 >= d) {
      w_d0 = 0;
      ++w_kc;
    }
    w_slot = w_slot == kRing - 1 ? 0 : w_slot + 1;
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) next_stage();
  TX xv[kSlabLoads];
  if constexpr (!kTmaX)
    if (n_stages > 0) wide::fetch_x(xt, rows, d, 0, xv);

  float acc[kLaneRows][kSlots];
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
    for (int j = 0; j < kSlots; ++j) acc[i][j] = 0.f;
  float xsq = 0.f;
  int c_read = 0;        // ring slot of stage s
  uint32_t parity = 0;   // of that slot's mbarrier phase
  int kc = 0, ds = 0;
  int n_q = n_chunks > 0 ? columns(0) : 0;
  for (int s = 0; s < n_stages; ++s) {
    float* const xslot = xring + (s & 1) * kDepth * kXLd;
    // slab s - 2 left this slot before the barrier of stage s - 1
    if (bar_used) mbar_wait(bars + c_read, parity);
    if (!c_tma) {
      if (s + 1 < n_stages)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    if constexpr (kTmaX)
      wide::transpose_raw(
          reinterpret_cast<const TX*>(raw + c_read * kRawSlot), xslot);
    else
      wide::store_x(xslot, xv);
    if (c_read == kRing - 1) parity ^= 1;
    __syncthreads();   // stage s in, and stage s - 1 read by every warp
    next_stage();      // into the slot stage s - 1 left
    const bool last = ds == n_ds - 1;
    if constexpr (!kTmaX)
      if (s + 1 < n_stages)
        wide::fetch_x(xt, rows, d, last ? 0 : (ds + 1) * kDepth, xv);
    if (kc == 0 && sq) {
      if constexpr (kTmaX && std::is_same<TX, float>::value) {
        // the swizzled raw slab: 8 float4 loads
        const float* const xr_row = raw + c_read * kRawSlot + sq_row * kDepth;
#pragma unroll
        for (int q = 0; q < kDepth / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              xr_row + (((q ^ sq_row) & 7) << 2));
          xsq = fmaf(v.x, v.x, xsq);
          xsq = fmaf(v.y, v.y, xsq);
          xsq = fmaf(v.z, v.z, xsq);
          xsq = fmaf(v.w, v.w, xsq);
        }
      } else {
#pragma unroll
        for (int f = 0; f < kDepth; ++f) {
          const float v = xslot[f * kXLd + sq_row];
          xsq = fmaf(v, v, xsq);
        }
      }
    }
    const float* const xa = xslot + xrow;
    const float* const cb = cring + c_read * kCSlot + cslot0;
    switch (n_q) {
      case 4: fma_stage<4>(xa, cb, acc); break;
      case 3: fma_stage<3>(xa, cb, acc); break;
      case 2: fma_stage<2>(xa, cb, acc); break;
      case 1: fma_stage<1>(xa, cb, acc); break;
      default: break;
    }
    c_read = c_read == kRing - 1 ? 0 : c_read + 1;
    if (!last) {
      ++ds;
      continue;
    }

    // The chunk's end.  Slot j of the lane is centroid 4 vq[j / 4] + j % 4;
    // it competes for the lane's rows when it lies below K in a group that
    // their tile computes.
    if (kc == 0 && sq) xsq_s[sq_row] = xsq;
    __syncthreads();   // |x|^2 in, and every warp's FMAs of the chunk done
    const int nl = chunk_vecs(kc);
    int vq[4], g0[4];
    unsigned comp = 0;   // bit j: slot j competes
    unsigned offs = 0;   // bits 2j, 2j + 1: slot j's group less g0[j / 4]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = wc * kHalfVecs + cx + 8 * q;
      vq[q] = p < nl ? ls.vec(kc, p) : -1;
      g0[q] = vq[q] >= 0 ? 4 * vq[q] / gs : -1;
      if (vq[q] < 0) continue;
      if (kVecGroups) {
        if (bit(need_w, g0[q])) comp |= 0xfu << (4 * q);
      } else {
        // one division, then a step where a group ends
        int grp = g0[q], end = (grp + 1) * gs;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = 4 * vq[q] + jj;
          if (col >= end) {
            ++grp;
            end += gs;
          }
          if (col < k && bit(need_w, grp)) comp |= 1u << (4 * q + jj);
          offs |= (unsigned)(grp - g0[q]) << (2 * (4 * q + jj));
        }
      }
    }
    // The distances replace the cross terms; this lane meets its slots in
    // increasing order, so the pair order reduces to: smaller, or the
    // first NaN.
    float best[kLaneRows];
    int arg[kLaneRows];
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      best[i] = INFINITY;
      arg[i] = 0x7fffffff;
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (!((comp >> j) & 1u)) continue;
      const int col = 4 * vq[j / 4] + j % 4;
      const float cn = csq[col];
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i) {
        const float xn = xsq_s[wide::row_of(xrow, i)];
        float v = __fadd_rn(xn - 2.f * acc[i][j], cn);
        v = v < 0.f ? 0.f : v;   // clamp; NaN stays NaN
        if (v < best[i] || (isnan(v) && !isnan(best[i]))) {
          best[i] = v;
          arg[i] = col;
        }
        acc[i][j] = v;
      }
    }
    // the 8 lanes of a row group; the halves merge below
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
        if (before(ob, oa, best[i], arg[i])) {
          best[i] = ob;
          arg[i] = oa;
        }
      }
      if (cx == 0) {
        const int row = wide::row_of(xrow, i);
        part_v[wc * kRows + row] = best[i];
        part_a[wc * kRows + row] = arg[i];
      }
    }
    // The group minima.  Slot positions follow the list, so groups are
    // runs of slots; lo[h] and hi[h] are the first and last computed group
    // of half h's slots, the chunk's first group may have begun in the
    // chunk before (its minimum so far in open) and its last may go on.
    int lo[kColWarps], hi[kColWarps];
#pragma unroll
    for (int h = 0; h < kColWarps; ++h) {
      lo[h] = hi[h] = -1;
      if (h * kHalfVecs < nl) {
        lo[h] = ls.first_group(ls.vec(kc, h * kHalfVecs));
        hi[h] = ls.last_group(ls.vec(kc, min(nl, (h + 1) * kHalfVecs) - 1));
      }
    }
    if (wc * kHalfVecs < nl) {
      // each group of this half that the warp's tile computes in turn: the
      // lanes' keys, merged over the 8 lanes of a row group
      const int ga = wc ? lo[1] : lo[0], gb = wc ? hi[1] : hi[0];
      for (int grp = next_set(need_w, ga, g); grp <= gb;
           grp = next_set(need_w, grp + 1, g)) {
        unsigned key[kLaneRows];
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i) key[i] = 0xffffffffu;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int gj =
              g0[j / 4] + (kVecGroups ? 0 : (int)((offs >> (2 * j)) & 3u));
          if (((comp >> j) & 1u) && gj == grp) {
#pragma unroll
            for (int i = 0; i < kLaneRows; ++i)
              key[i] = min(key[i], f8::key_of(acc[i][j]));
          }
        }
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            key[i] = min(key[i], __shfl_xor_sync(0xffffffffu, key[i], off));
        // lane cx keeps row i = cx
        unsigned v = key[0];
#pragma unroll
        for (int i = 1; i < kLaneRows; ++i) v = cx == i ? key[i] : v;
        const int row = wide::row_of(xrow, cx);
        if (grp != ga && grp != gb) {
          if (row < rows) gmint[(int64_t)row * g + grp] = f8::dist_of(v);
        } else {
          if (grp == ga) ends[(2 * wc) * kRows + row] = v;
          if (grp == gb) ends[(2 * wc + 1) * kRows + row] = v;
        }
      }
    }
    __syncthreads();   // the halves' row minima and end groups in
    if (tid < kRows) {
      // each row's running (min, argmin): the halves in any order
      float bv = run_v[tid];
      int ba = run_a[tid];
#pragma unroll
      for (int h = 0; h < kColWarps; ++h) {
        const float ov = part_v[h * kRows + tid];
        const int oa = part_a[h * kRows + tid];
        if (before(ov, oa, bv, ba)) {
          bv = ov;
          ba = oa;
        }
      }
      if (kc < n_chunks - 1) {
        run_v[tid] = bv;
        run_a[tid] = ba;
      } else if (tid < rows) {
        labels[at + tid] = ba >= 0 ? ba : lab0[at + tid];
        mind[at + tid] = bv;
      }
    } else {
      // each row's end groups in slot order, one group at a time
      const int row = tid - kRows;
      const unsigned* const need_r = need + (row / kTileRows) * nw;
      const int v_first = ls.vec(kc, 0), v_last = ls.vec(kc, nl - 1);
      const int g_first = lo[0], g_last = nl > kHalfVecs ? hi[1] : hi[0];
      const bool begun = g_first * gs < 4 * v_first;
      const bool goes_on = min((g_last + 1) * gs, k) - 1 > 4 * v_last + 3;
      int cur_g = -1;
      unsigned cur = 0xffffffffu;
      auto feed = [&](int grp, unsigned key) {
        if (!bit(need_r, grp)) return;
        if (grp != cur_g) {
          if (cur_g >= 0 && row < rows)
            gmint[(int64_t)row * g + cur_g] = f8::dist_of(cur);
          cur_g = grp;
          cur = key;
        } else {
          cur = min(cur, key);
        }
      };
      if (begun) feed(g_first, open[row]);
#pragma unroll
      for (int h = 0; h < kColWarps; ++h) {
        if (h * kHalfVecs >= nl) continue;
        feed(lo[h], ends[(2 * h) * kRows + row]);
        feed(hi[h], ends[(2 * h + 1) * kRows + row]);
      }
      if (cur_g >= 0) {
        if (goes_on && cur_g == g_last)
          open[row] = cur;
        else if (row < rows)
          gmint[(int64_t)row * g + cur_g] = f8::dist_of(cur);
      }
    }
    // chunk kc's list is read: list chunk kc + kLists - 1 in the window
    if (kc + kLists - 1 < n_chunks) ls.fill(kc + kLists - 1);
    // the next chunk's cross terms start from 0
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
      for (int j = 0; j < kSlots; ++j) acc[i][j] = 0.f;
    ds = 0;
    ++kc;
    n_q = kc < n_chunks ? columns(kc) : 0;
  }
  if (n_chunks == 0 && tid < rows) {   // every group skipped: the seed
    labels[at + tid] = lab0[at + tid];
    mind[at + tid] = run_v[tid];
  }
}

// The streamed bounded sweep on stream s over ct and csq (prepare_c's): X
// by TMA where its rows start 16-byte aligned, else by plain loads.  Returns
// cudaErrorInvalidValue where the shared memory for G groups' need bits
// exceeds what a block may opt in to.
template <bool kVecGroups, typename TX>
__host__ inline cudaError_t launch(cudaStream_t s, const TX* x,
                                   int64_t x_rstride, const float* ct,
                                   const float* csq, const int* lab0,
                                   const float* lb, const float* ub, int r,
                                   int n, int k, int d, int gs, int g,
                                   int* labels, float* mind, float* gmin,
                                   int* part_skip) {
  CUtensorMap cmap{}, xmap{};
  cudaError_t err = wide::encode_c_map(&cmap, ct, r, k, d);
  if (err != cudaSuccess) return err;
  const bool tma_x = wide::x_tma_aligned(x, x_rstride, d);
  if (tma_x) {
    err = wide::encode_x_map(&xmap, x, x_rstride, r, n, d);
    if (err != cudaSuccess) return err;
  }
  auto kernel = tma_x ? bounds_stream<kVecGroups, TX, true>
                      : bounds_stream<kVecGroups, TX, false>;
  const size_t smem = smem_bytes(g);
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(n, kRows), r), kThreads, smem, s>>>(
      cmap, xmap, x, x_rstride, ct, csq, lab0, lb, ub, n, k, d, gs, g,
      labels, mind, gmin, part_skip);
  return cudaGetLastError();
}

}  // namespace bwide
}  // namespace repro
