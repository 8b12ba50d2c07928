// The streamed nearest-centroid sweep for rows wider than the resident X
// tile (past 821 features on an H100, or where a launcher forces it): the
// assignment kernel's launch and the fused step's sweep past the resident
// path, on float32 or mixed operands.  launch_assign (the one launcher of
// both) picks it, sweep_fp32.cuh's resident assign_tiles, or, where X and
// C are both bfloat16, sweep_tc.cuh's tensor-core sweep.  The bounded
// step's streamed sweep (sweep_bounded.cuh) is built on this design.
//
// What bounds it: 2*N*K*d FP32 operations on the CUDA cores (67 TFLOP/s):
// 4.02 ms at 128,256 x 4096, K = 256, against 2.1 GB of X read once (0.63
// ms at 3.35 TB/s).  Split TF32 on the tensor cores missed the kernels'
// 1e-5 gate (sweep_fp32.cuh), so the FMA rate is the roof, and the design
// is an FP32 GEMM whose epilogue is the argmin.
//
// Where the 8 x 8 streamed sweep this replaced (once in sweep_fp32.cuh,
// and the bounded step's until sweep_bounded.cuh replaced it too) lost
// time: 7.37 ms on an H100 SXM, 1.36x addmm + argmin.  Its running minima
// (16 registers) and the prefetched slab stayed live across the FMA loop,
// so ptxas spilled 492 bytes; two warps carried the 64 |x|^2 chains while
// six waited at the next barrier; two barriers guarded each 32-feature
// stage of a two-slot ring; and each 64 FMAs of a lane cost four 16-byte
// shared loads.
//
// This design (each choice timed in turns against alternatives on the
// card; PERF.md lists them):
//  - 8 rows x 16 slots of cross terms a lane (128 accumulators, one
//    256-thread block an SM), lanes 4 (rows) x 8 (slots), a lane's rows
//    4 + 4 sixteen apart and its slots 4 x 4 thirty-two apart: a feature
//    costs 2 + 4 float4 loads for 128 FMAs.  Warps 4 (rows) x 2 (slots)
//    cover a 128-row x 256-slot tile, so a 16,384-row predict chunk is 128
//    blocks on the 132 SMs.
//  - The FMA loop takes 4 features a trip, each C value meeting the
//    lane's 8 rows in turn (a fully unrolled 32-feature stage, 64 KB of
//    code, and rows outer both ran slower).
//  - No running minimum in registers across the FMA loop: after a chunk's
//    last stage each lane takes its rows' minima over its slots, lanes
//    merge by shuffles, warps through shared memory, and one thread a row
//    folds them into the row's running minimum, kept in shared memory
//    between chunks, all in nearest.cuh's total order (NaN first, value,
//    index).  That order gives the sequential scan's answer under any
//    split of a row's slots: a lane scans its slots in increasing order
//    from (inf, 0) and takes a distance that is smaller, or the first NaN,
//    which is the minimum under before() of the pairs it saw (ties keep
//    the lower index); before() is a strict total order on pairs with
//    distinct indices, so the minimum of minima over lanes, warps and
//    chunks, in any grouping, is the minimum over all slots.  The start
//    (inf, 0) is centroid 0's pair where its distance is +inf, and loses
//    to every other pair: a row whose every distance is +inf gets label
//    0, as the first index of the minimum, and never an index >= K.
//  - Stages of 32 features in a three-slot ring, two stages ahead, one
//    block barrier a stage.  One thread starts each stage's copies by TMA
//    onto the slot's mbarrier: C's (32 features x 256 slots of the
//    transposed ct) and, where X's rows start 16-byte aligned (the base,
//    d and the problem stride), X's (32 features x 128 rows, f32 with
//    TMA's 128-byte swizzle, bf16 unswizzled).  Before the stage's barrier
//    each thread moves a 4 x 4 block of that raw slab into the transposed
//    (feature-major, f32) slab the FMA loop reads: 4 + 4 float4 accesses,
//    no bank conflict.  Other rows (f32 rows of odd width, a base off 16
//    bytes) take plain loads, issued a stage ahead into registers and
//    stored transposed before the next barrier.  Past d and past n both
//    paths give zeros: fma(0, 0, acc) leaves every distance as it was.
//  - The |x|^2 chains, one a row, run in four warps (one on each SM
//    sub-partition) on the first chunk's slabs: from the swizzled raw slab
//    (8 float4 loads a stage) where f32 rows came by TMA, else from the
//    transposed slab.
//  - A wait on an mbarrier that never completes traps after 2^24 polls,
//    so a copy that went wrong fails the launch instead of hanging it.
//
// Numbers: every cross term is one FMA chain over the features in
// increasing order from 0, |x|^2 one FMA chain a row in column order, and
// the distance max(|x|^2 - 2 x.c + |c|^2, 0) as the resident sweep writes
// it, so labels and distances equal the resident launch's bit for bit
// wherever both fit, and a bf16 X against f32 C equals the f32 launch on
// the upcast X, whichever way X arrives.  No split of the feature axis and
// no atomics: a relaunch is bitwise equal.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "sweep_fp32.cuh"
#include "sweep_tc.cuh"

namespace repro {
namespace wide {

constexpr int kRowWarps = 4;                      // warps along the rows
constexpr int kGroups = 4;                        // float4 of C a lane holds
constexpr int kLaneRows = 8;                      // X rows a lane holds
constexpr int kSlots = 4 * kGroups;               // C slots a lane holds
constexpr int kWarpRows = 32;                     // X rows a warp holds
constexpr int kWarpSlots = 32 * kGroups;          // C slots a warp holds
constexpr int kColWarps = f8::kCents / kWarpSlots;
constexpr int kWarps = kRowWarps * kColWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kWarpRows * kRowWarps;      // X rows per block
constexpr int kDepth = 32;                        // features per stage
constexpr int kRing = 3;                          // stages in the ring
constexpr int kCents = f8::kCents;                // slots per chunk
constexpr int kCSlot = kDepth * kCents;           // floats of a C stage
constexpr int kRawSlot = kRows * kDepth;          // floats of a raw X slab
constexpr int kXLd = kRows + 4;                   // pitch of an X slab row
constexpr int kSlabLoads = kRows * kDepth / kThreads;
constexpr int kSqRows = kRows / 4;                // |x|^2 rows of a warp
static_assert(kThreads == 256 && kDepth == 32 &&
                  kSlabLoads * kThreads == kRows * kDepth &&
                  (kRows / 4) * (kDepth / 4) == kThreads &&
                  kColWarps * kWarpSlots == kCents,
              "the block's shape");

// Shared memory: slack to align the rings to 1024 bytes (TMA's 128-byte
// swizzle), the C ring, the raw X ring, two transposed X slabs, |x|^2, the
// warps' row minima (value and index), the running minima (value and
// index) and the ring's mbarriers.
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 +
         sizeof(float) * ((size_t)kRing * (kCSlot + kRawSlot) +
                          2 * kDepth * kXLd + kRows + 2 * kColWarps * kRows +
                          2 * kRows) +
         sizeof(uint64_t) * kRing;
}

// X's element as it is loaded: streamed once per chunk, so evicted first
// and C stays in L2.
__device__ __forceinline__ float load_x(const float* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 load_x(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// Thread's element q of a slab: feature and row within it.  A warp
// instruction covers 8 features x 4 rows.
__device__ __forceinline__ int slab_feature(int q) {
  const int b = threadIdx.x / 32 + q * kWarps;
  return (b % (kDepth / 8)) * 8 + threadIdx.x % 8;
}
__device__ __forceinline__ int slab_row(int q) {
  const int b = threadIdx.x / 32 + q * kWarps;
  return (b / (kDepth / 8)) * 4 + (threadIdx.x % 32) / 8;
}

// The slab of features [d0, d0 + kDepth) of the block's rows (xt: its
// first row, `rows` of them hold data) into registers; zero past the rows
// and past d.
template <typename TX>
__device__ __forceinline__ void fetch_x(const TX* __restrict__ xt, int rows,
                                        int d, int d0,
                                        TX (&v)[kSlabLoads]) {
#pragma unroll
  for (int q = 0; q < kSlabLoads; ++q) {
    const int f = d0 + slab_feature(q), row = slab_row(q);
    v[q] = row < rows && f < d ? load_x(xt + (int64_t)row * d + f) : TX();
  }
}

// fetch_x's elements into a slab slot, transposed (slot[feature * kXLd +
// row]) and converted to f32.
template <typename TX>
__device__ __forceinline__ void store_x(float* slot,
                                        const TX (&v)[kSlabLoads]) {
#pragma unroll
  for (int q = 0; q < kSlabLoads; ++q)
    slot[slab_feature(q) * kXLd + slab_row(q)] = to_f32(v[q]);
}

// A raw f32 slab (row-major, 128-byte rows, TMA's 128-byte swizzle: the
// 16-byte chunk q of row r at chunk q ^ (r % 8)) into the transposed slab,
// a 4 x 4 block a thread: 8 threads read a row's 8 chunks, and the stores
// of a warp fall on 8 distinct 16-byte bank groups 4 times.
__device__ __forceinline__ void transpose_raw(const float* raw, float* slot) {
  const int fq = threadIdx.x % 8, rq = threadIdx.x / 8;
  float4 v[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = 4 * rq + rr;
    v[rr] = *reinterpret_cast<const float4*>(raw + row * kDepth +
                                             (((fq ^ row) & 7) << 2));
  }
  float* const dst = slot + 4 * fq * kXLd + 4 * rq;
  *reinterpret_cast<float4*>(dst) = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
  *reinterpret_cast<float4*>(dst + kXLd) =
      make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
  *reinterpret_cast<float4*>(dst + 2 * kXLd) =
      make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
  *reinterpret_cast<float4*>(dst + 3 * kXLd) =
      make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
}

// A raw bf16 slab (row-major, 64-byte rows, unswizzled) into the
// transposed slab, converted to f32 (exactly: a bf16 is an f32's top half).
__device__ __forceinline__ void transpose_raw(const __nv_bfloat16* raw,
                                              float* slot) {
  const int fq = threadIdx.x % 8, rq = threadIdx.x / 8;
  float v[4][4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        raw + (4 * rq + rr) * kDepth + 4 * fq);
    v[rr][0] = __uint_as_float(u.x << 16);
    v[rr][1] = __uint_as_float(u.x & 0xffff0000u);
    v[rr][2] = __uint_as_float(u.y << 16);
    v[rr][3] = __uint_as_float(u.y & 0xffff0000u);
  }
  float* const dst = slot + 4 * fq * kXLd + 4 * rq;
#pragma unroll
  for (int ff = 0; ff < 4; ++ff)
    *reinterpret_cast<float4*>(dst + ff * kXLd) =
        make_float4(v[0][ff], v[1][ff], v[2][ff], v[3][ff]);
}

// A lane's row i of the tile (from its first, `first`): 4 consecutive
// rows a group, groups 16 apart.  Its slot j of a chunk: 4 consecutive
// slots a group, groups 32 apart, so its slots increase with j.
__device__ __forceinline__ int row_of(int first, int i) {
  return first + (i / 4) * 16 + i % 4;
}
__device__ __forceinline__ int slot_of(int first, int j) {
  return first + (j / 4) * 32 + j % 4;
}

// One kRows-row tile of X a block (blockIdx.x), one problem a grid row
// (blockIdx.y): each row's label and min distance against the k centroids
// of its problem (cmap: C transposed, prepare_c's ct, as (k_pad, d, R);
// csq: |c|^2).  kTmaX: X's slabs come by TMA through xmap, else by plain
// loads from x.
template <typename TX, bool kTmaX>
__global__ void __launch_bounds__(kThreads, 1)
assign_stream(const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap xmap,
              const TX* __restrict__ x, int64_t x_rstride,
              const float* __restrict__ csq,
              int n, int k, int d, int* __restrict__ labels,
              float* __restrict__ mind) {
  extern __shared__ float4 smem_raw[];
  const unsigned base = smem_addr(smem_raw);
  float* const cring = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem_raw) + ((1024 - base % 1024) % 1024));
  float* const raw = cring + kRing * kCSlot;
  float* const xring = raw + kRing * kRawSlot;
  float* const xsq_s = xring + 2 * kDepth * kXLd;
  float* const part_v = xsq_s + kRows;
  int* const part_a = reinterpret_cast<int*>(part_v + kColWarps * kRows);
  float* const run_v = reinterpret_cast<float*>(part_a + kColWarps * kRows);
  int* const run_a = reinterpret_cast<int*>(run_v + kRows);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(run_a + kRows);

  const int r = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int rows = n - row0 < kRows ? (int)(n - row0) : kRows;
  const TX* const xt = x + r * x_rstride + row0 * d;
  csq += (int64_t)r * k;
  const int n_ds = cdiv(d, kDepth);
  const int n_chunks = cdiv(k, kCents);
  const int n_stages = n_chunks * n_ds;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = warp / kColWarps, wc = warp % kColWarps;
  const int ry = lane / 8, cx = lane % 8;
  // this lane's rows: row_of(xrow, i); its slots of a chunk:
  // slot_of(cslot0, j)
  const int xrow = wr * kWarpRows + ry * 4;
  const int cslot0 = wc * kWarpSlots + cx * 4;
  // the |x|^2 chains: warps 0-3, kSqRows rows each
  const bool sq = warp < 4 && lane < kSqRows;
  const int sq_row = warp * kSqRows + lane;

  // the ring's stages: C's box, and X's where it comes by TMA
  constexpr uint32_t kStageBytes =
      sizeof(float) * kCSlot + (kTmaX ? sizeof(TX) * kRawSlot : 0);
  const int xr = x_rstride ? r : 0;   // X's problem coordinate
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the next stage to copy: chunk w_kc, features w_d0 on, into slot w_slot
  int w_kc = 0, w_d0 = 0, w_slot = 0;
  auto next_stage = [&]() {
    if (w_kc == n_chunks) return;
    if (threadIdx.x == 0) {
      mbar_expect(bars + w_slot, kStageBytes);
      tma3(cring + w_slot * kCSlot, &cmap, w_kc * kCents, w_d0, r,
           bars + w_slot);
      if (kTmaX)
        tma3(raw + w_slot * kRawSlot, &xmap, w_d0, (int)row0, xr,
             bars + w_slot);
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
  if constexpr (!kTmaX) fetch_x(xt, rows, d, 0, xv);

  float acc[kLaneRows][kSlots];
#pragma unroll
  for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
    for (int j = 0; j < kSlots; ++j) acc[i][j] = 0.f;
  float xsq = 0.f;
  int c_read = 0;   // ring slot of stage s
  uint32_t parity = 0;   // of that slot's mbarrier phase
  int kc = 0, ds = 0;
  for (int s = 0; s < n_stages; ++s) {
    float* const xslot = xring + (s & 1) * kDepth * kXLd;
    // slab s - 2 left this slot before the barrier of stage s - 1
    mbar_wait(bars + c_read, parity);
    if constexpr (kTmaX)
      transpose_raw(reinterpret_cast<const TX*>(raw + c_read * kRawSlot),
                    xslot);
    else
      store_x(xslot, xv);
    if (c_read == kRing - 1) parity ^= 1;
    __syncthreads();   // stage s in, and stage s - 1 read by every warp
    next_stage();      // into the slot stage s - 1 left
    const bool last = ds == n_ds - 1;
    if constexpr (!kTmaX)
      if (s + 1 < n_stages)
        fetch_x(xt, rows, d, last ? 0 : (ds + 1) * kDepth, xv);
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
    // 4 features a trip; each C value meets the lane's rows in turn
#pragma unroll 4
    for (int f = 0; f < kDepth; ++f) {
      float av[kLaneRows], bv[kSlots];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 a =
            *reinterpret_cast<const float4*>(xa + f * kXLd + 16 * g);
        av[4 * g] = a.x;
        av[4 * g + 1] = a.y;
        av[4 * g + 2] = a.z;
        av[4 * g + 3] = a.w;
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 b =
            *reinterpret_cast<const float4*>(cb + f * kCents + 32 * g);
        bv[4 * g] = b.x;
        bv[4 * g + 1] = b.y;
        bv[4 * g + 2] = b.z;
        bv[4 * g + 3] = b.w;
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    c_read = c_read == kRing - 1 ? 0 : c_read + 1;
    if (!last) {
      ++ds;
      continue;
    }

    // The chunk's distances.  This lane meets its slots in increasing
    // order, so the pair order reduces to: smaller, or the first NaN.
    if (kc == 0 && sq) xsq_s[sq_row] = xsq;
    __syncthreads();   // |x|^2 in
    float best[kLaneRows];
    int arg[kLaneRows];
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      best[i] = INFINITY;
      arg[i] = 0;   // (inf, 0): see the header
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int col = kc * kCents + slot_of(cslot0, j);
      if (col < k) {               // the ragged K edge never competes
        const float cn = csq[col];
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i) {
          const float xn = xsq_s[row_of(xrow, i)];
          float v = __fadd_rn(xn - 2.f * acc[i][j], cn);
          v = v < 0.f ? 0.f : v;   // clamp; NaN stays NaN
          if (v < best[i] || (isnan(v) && !isnan(best[i]))) {
            best[i] = v;
            arg[i] = col;
          }
        }
      }
    }
    // the next chunk's cross terms start from 0
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
      for (int j = 0; j < kSlots; ++j) acc[i][j] = 0.f;
    // the 8 lanes of a row group, then the kColWarps warps of a row
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
        const int row = row_of(xrow, i);
        part_v[wc * kRows + row] = best[i];
        part_a[wc * kRows + row] = arg[i];
      }
    }
    __syncthreads();   // the warps' minima in
    if (threadIdx.x < kRows) {
      const int t = threadIdx.x;
      float bv = kc == 0 ? INFINITY : run_v[t];
      int ba = kc == 0 ? 0x7fffffff : run_a[t];
#pragma unroll
      for (int q = 0; q < kColWarps; ++q) {
        const float ov = part_v[q * kRows + t];
        const int oa = part_a[q * kRows + t];
        if (before(ov, oa, bv, ba)) {
          bv = ov;
          ba = oa;
        }
      }
      if (kc < n_chunks - 1) {
        run_v[t] = bv;
        run_a[t] = ba;
      } else if (t < rows) {
        labels[(int64_t)r * n + row0 + t] = ba;
        mind[(int64_t)r * n + row0 + t] = bv;
      }
    }
    ds = 0;
    ++kc;
  }
}

// C transposed (prepare_c's ct: (R, d, k_pad) f32) as a tensor map of
// boxes of kCents slots x kDepth features, zero past d.
__host__ inline cudaError_t encode_c_map(CUtensorMap* map, const float* ct,
                                         int r, int k, int d) {
  const uint64_t k_pad = f8::pad_centroids(k);
  const uint64_t dims[3] = {k_pad, (uint64_t)d, (uint64_t)r};
  const uint64_t strides[2] = {k_pad * sizeof(float),
                               d * k_pad * sizeof(float)};
  const uint32_t box[3] = {kCents, kDepth, 1};
  return encode3(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ct, dims, strides,
                 box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Whether X's rows start 16-byte aligned (the base, d and the problem
// stride), so that its slabs may come by TMA.
template <typename TX>
__host__ inline bool x_tma_aligned(const TX* x, int64_t x_rstride, int d) {
  constexpr int kAlign = 16 / sizeof(TX);   // elements in 16 bytes
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && d % kAlign == 0 &&
         x_rstride % kAlign == 0;
}

// X (R, n, d), or one (n, d) that every problem reads (x_rstride 0), as a
// tensor map of boxes of kDepth features x kRows rows, zero past d and n:
// f32 with TMA's 128-byte swizzle, bf16 unswizzled.
template <typename TX>
__host__ inline cudaError_t encode_x_map(CUtensorMap* map, const TX* x,
                                         int64_t x_rstride, int r, int n,
                                         int d) {
  constexpr bool kF32 = std::is_same<TX, float>::value;
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)n,
                            (uint64_t)(x_rstride ? r : 1)};
  const uint64_t strides[2] = {
      d * sizeof(TX), (x_rstride ? x_rstride : (int64_t)n * d) * sizeof(TX)};
  const uint32_t box[3] = {kDepth, kRows, 1};
  return encode3(map,
                 kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 x, dims, strides, box,
                 kF32 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The streamed sweep on stream s over ct and csq (prepare_c's): X by TMA
// where its rows start 16-byte aligned, else by plain loads.
template <typename TX>
__host__ inline cudaError_t launch(cudaStream_t s, const TX* x,
                                   int64_t x_rstride, const float* ct,
                                   const float* csq, int r, int n, int k,
                                   int d, int* labels, float* mind) {
  CUtensorMap cmap{}, xmap{};
  cudaError_t err = encode_c_map(&cmap, ct, r, k, d);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, kRows), r);
  if (x_tma_aligned(x, x_rstride, d)) {
    err = encode_x_map(&xmap, x, x_rstride, r, n, d);
    if (err != cudaSuccess) return err;
    err = set_smem(assign_stream<TX, true>, smem_bytes());
    if (err != cudaSuccess) return err;
    assign_stream<TX, true><<<grid, kThreads, smem_bytes(), s>>>(
        cmap, xmap, x, x_rstride, csq, n, k, d, labels, mind);
  } else {
    err = set_smem(assign_stream<TX, false>, smem_bytes());
    if (err != cudaSuccess) return err;
    assign_stream<TX, false><<<grid, kThreads, smem_bytes(), s>>>(
        cmap, xmap, x, x_rstride, csq, n, k, d, labels, mind);
  }
  return cudaGetLastError();
}

}  // namespace wide

namespace f8 {

// Floats of scratch one assignment launch needs: the FP32 sweeps' (C
// transposed, |c|^2) or the tensor-core sweep's (C packed in bf16, |c|^2),
// whichever is more.
__host__ inline long long assign_scratch_floats(int r, int k, int d) {
  const long long a = scratch_floats(r, k, d), b = tc::scratch_floats(r, k, d);
  return a > b ? a : b;
}

// The assignment on stream s into labels and mind, with scratch
// (assign_scratch_floats(r, k, d) floats, 16-byte aligned).  The
// assignment kernel's launch and the fused step's sweep, so the two give
// the same labels and distances by construction.  X and C both bfloat16:
// the tensor-core sweep (sweep_tc.cuh) at any d; it has no streamed FP32
// path, so force_stream is refused.  Otherwise (float32, or one operand of
// each type, computed in f32 as JAX promotes them): |c|^2 and C's
// transpose into scratch, then assign_tiles with the X tile resident, or
// wide::assign_stream, as plan_sweep decides (force_stream: streamed at
// any d), on the operands' f32 values.
template <typename TX, typename TC>
__host__ inline cudaError_t launch_assign(cudaStream_t s, const TX* x,
                                          int64_t x_rstride, const TC* c,
                                          int r, int n, int k, int d,
                                          bool force_stream, float* scratch,
                                          int* labels, float* mind) {
  if constexpr (std::is_same<TX, __nv_bfloat16>::value &&
                std::is_same<TC, __nv_bfloat16>::value) {
    if (force_stream) return cudaErrorInvalidValue;
    return tc::launch(s, x, x_rstride, c, r, n, k, d, scratch, labels, mind);
  } else {
    SweepPlan plan;
    cudaError_t err = plan_sweep(d, 0, false, force_stream, &plan);
    if (err != cudaSuccess) return err;
    float *ct, *csq;
    err = prepare_c(s, c, r, k, d, scratch, &ct, &csq);
    if (err != cudaSuccess) return err;
    if (plan.stream)
      return wide::launch(s, x, x_rstride, ct, csq, r, n, k, d, labels, mind);
    err = set_smem(assign_tiles<TX>, plan.smem);
    if (err != cudaSuccess) return err;
    assign_tiles<TX><<<dim3(cdiv(n, kRows), r), kThreads, plan.smem, s>>>(
        x, x_rstride, ct, csq, n, k, d, plan.dc, labels, mind);
    return cudaGetLastError();
  }
}

}  // namespace f8
}  // namespace repro
