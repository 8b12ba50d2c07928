// The nearest-centroid sweep on Hopper's tensor cores, for bfloat16 X and
// C, at every d.  Three kernels take it whenever both operands are bf16:
// the assignment kernel's launch and the fused step's sweep
// (f8::launch_assign in sweep_wide.cuh picks it), and the bounded step's
// sweep where gs is a multiple of 8 (fused_bounds.cu; the form with
// kBounded, below).  Mixed and f32 operands keep the FP32 sweeps.
//
// Replaces, for bf16 operands, the cross term of the TPU kernels
// src/repro/kernels/assignment.py::_assignment_kernel (:49-51),
// src/repro/kernels/fused_lloyd.py::_fused_kernel (:69-71) and
// ::_fused_bounds_kernel (:171): a dot_general of the bf16 operands with
// preferred_element_type=f32 on the MXU.  A product of two bf16 values is
// exact in f32, so only the order of the f32 sums differs; the
// reference's contract (labels exact up to near ties, distances within
// reduction-order tolerance) covers that.
//
// What bounds it on an H100 SXM: 2*N*K*d bf16 products at 989 TFLOP/s,
// N*d*2 bytes of X at 3.35 TB/s, or the epilogue's 7 instructions per
// (row, centroid) on the CUDA cores (take(): FFMA, FADD, FMNMX, IADD3,
// ISETP, 2 SEL): at 2,458,285 x 69, K = 1000 the products take 0.34 ms
// and the epilogue 0.51 ms of issue; at 128,256 x 4096, K = 256 the
// products 0.27 ms against X's 0.31 ms of bytes.
//
// The design (each choice timed on the card against the others,
// scripts/tc_sweep_probe.py and PERF.md):
//  - A block is 128 rows of X and all K: two warpgroups of 64 rows each,
//    walking the centroids in chunks of 128 slots, one m64n128k16
//    accumulator each.  No producer warp: ptxas sizes a wgmma kernel's
//    threads by whole warpgroups (168 registers a thread at 288 or 384
//    threads, setmaxnreg or not), and the streamed sweep's accumulator and
//    total need more; thread 0 starts each stage's copies by TMA onto its
//    ring slot's mbarrier, refilling the slot the block left a stage
//    earlier.  The two warpgroups meet the tensor cores in turn.
//  - Products: wgmma.mma_async, f32 += bf16 x bf16, both operands K-major
//    in shared memory with the 128-byte swizzle (a slab is 64 features:
//    one 128-byte line a row), the accumulator in registers.
//  - C: packed once per launch (pack_c) into scratch as bf16 (R, K padded
//    to 128, d padded to 16), zero past K and d, with |c|^2 in f32 from the
//    bf16 values (row_sqnorms' FMA chain and shuffle tree) and +inf past
//    K: a padded slot's distance is +inf, so it never beats a real one (an
//    equal +inf goes to the lower, real index).  Each stage's box of 128
//    slots x 64 features comes by TMA with the 128-byte swizzle.
//  - X up to d = 192 (padded): resident.  Each warpgroup stores its 64 rows
//    once, in the swizzled layout with zeros past d and N, by 16-byte
//    loads where a row group starts 16-byte aligned, else by 2-byte loads
//    (USCensus1990's 138-byte bf16 rows cannot be a TMA box), a slab's
//    loads all issued before its stores; the ring carries C alone, four
//    stages, so two blocks share an SM and one's loads and epilogue
//    overlap the other's products.
//  - Wider X streams: each of six stages carries X's 128-row slab beside
//    C's, by TMA where X's rows start 16-byte aligned (base, d and problem
//    stride), else each warpgroup stores its own rows of the slab as it
//    starts the stage.
//  - Accuracy: the tensor cores add their f32 sums by aligning and
//    truncating.  Streamed X adds each 64-feature slab's products into an
//    f32 register total with round to nearest (the promotion), so the
//    truncation spans 4 k-steps and not d/16: on the H100 the cross terms
//    stayed within 4.3e-7 of |x| |c| of an f64 product at d = 69, 821 and
//    4096, and without the promotion erred by 1.35e-5 at d = 4096.
//  - |x|^2: an f32 FMA chain over the bf16 values in column order (the
//    reference's xsq), one a 64-feature slab, each added into the row's
//    total in slab order: from the swizzled slabs once the resident tile
//    is in, or stage by stage over the first chunk.  One chain over all of
//    d = 4096 drifted 8.3e-6 of |x|^2 + max |c|^2 from the plain version's
//    sum on the H100 (its bf16 products round with a bias; the gate is
//    1e-5).
//  - Epilogue, per accumulator element: max(|x|^2 - 2 x.c + |c|^2, 0)
//    (NaN passed through) in the reference's order, its bits + 1 as a
//    signed key (so a NaN, 0x7fffffff, is the lowest key), and a running
//    (key, index) per row in registers across the chunks.  A thread meets
//    its slots in increasing order and keeps the strictly smaller key, so
//    the four lanes of a row merge by (key, index): nearest.cuh's total
//    order (NaN first, value, index), the lowest index winning a tie.
//  - Each block owns its rows and all K; no atomics; the order of every
//    sum is fixed by the shapes.  A relaunch is bitwise equal, and the
//    assignment and the fused step, one sweep, are equal bit for bit.
//
// The bounded step (bounds_tc: the bound contract of fused_bounds.cu and
// ref.py::fused_bounds_ref on this sweep, one body with assign_tc):
//  - Each warpgroup's 64 rows are one tile of the skip test (f8::kRows):
//    group g of the tile is computed when any of its real rows has
//    lb^2 <= ub^2; the warpgroup sets its need bits (atomicOr, whose result
//    is order-free), writes g less the computed count to part_skip and
//    passes each skipped group's lb^2 to gmin bit for bit.
//  - Chunk skip lists: a 128-slot chunk is needed by a tile when a group
//    that the tile computes meets its slots below K.  The block lists the
//    union of its two tiles' chunks in order; thread 0 starts stages only
//    for listed chunks (the ring counts list positions), and both
//    warpgroups multiply every listed chunk.  (Skipping the wgmma of a
//    chunk that only the other tile needs puts it on a path that ptxas
//    cannot prove uniform over the warpgroup, whatever broadcast decides
//    it: it then serializes every wgmma of the kernel (C7520), and the
//    step at USCensus1990 took about twice the fused step's time; PERF.md.)
//    An empty list starts no stage, and the rows keep (ub^2, lab0).  The
//    work follows the listed chunks: with gs >= 128 about the computed
//    share of the groups; with smaller gs a chunk that holds one computed
//    group of either tile is multiplied whole.  Streamed X takes its |x|^2
//    chains over the first listed chunk's slabs.
//  - Epilogue: take()'s distance and key; a slot of a group that the tile
//    skips gets no key, so it never competes.  gs % 8 == 0, so an
//    accumulator's 8-column block lies in one group, the same for every
//    lane; the skip test leaves each tile a 16-bit mask a chunk, the
//    blocks whose group it computes.  A running minimum key per row (NaN
//    lowest, as torch.amin propagates it) of the open group is merged over
//    the row's four lanes by shuffles when the next computed group opens
//    or the sweep ends, and written by lane 0 of the quad.  The keys and
//    the group minima come in one straight pass over the chunk where it
//    meets one group (most chunks when gs >= 128; without the masks where
//    the tile computes all of it) or two (gs >= 64); else the keys replace
//    the cross terms, then the minima take them block by block.  The
//    epilogue issues about 9 instructions a (row, centroid), not take()'s
//    7.  A branch on each block (16 short runs with little to overlap),
//    or the group test made again in every chunk, cost more than the
//    minima themselves (PERF.md).  ptxas still serializes the wgmma around
//    the group closes (C7520), which costs little at d = 69
//    (scripts/bounds_tc_variant_probe.py).
//  - The seed: the lanes' (key, index) merge as in assign_tc, then the
//    seed (ub^2, lab0) once a row by the reference's rule, so the seed
//    wins every tie.  With ub^2 = +inf, lb^2 = 0 on finite rows every cell
//    is computed and no seed wins: labels and distances are the fused
//    step's bit for bit, and each row's least group minimum its distance.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "nearest.cuh"

namespace repro {

// Words of a bit set of n bits (a tile's need bits: one a group).
__host__ __device__ inline int need_words(int g) { return cdiv(g, 32); }

// Whether bit grp of a bit set is on.
__device__ __forceinline__ bool bit(const unsigned* words, int grp) {
  return (words[grp >> 5] >> (grp & 31)) & 1u;
}

// The first set bit from grp on among g, or g when there is none.
__device__ __forceinline__ int next_set(const unsigned* words, int grp,
                                        int g) {
  while (grp < g) {
    const unsigned word = words[grp >> 5] >> (grp & 31);
    if (word) return grp + __ffs(word) - 1;
    grp = (grp | 31) + 1;
  }
  return g;
}

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;         // X rows per block, 64 per consumer
constexpr int kDepth = 64;         // features per slab (a 128-byte line)
constexpr int kStep = 16;          // features per wgmma (k16)
constexpr int kResident = 192;     // widest padded d kept resident
constexpr int kThreads = 256;      // two warpgroups
constexpr int kXSlab = kRows * kDepth * 2;  // bytes of an X slab
static_assert(kDepth * 2 == 128 && kResident % kDepth == 0,
              "128-byte swizzled lines");

constexpr int kSlots = 128;        // centroid slots per chunk (wgmma N)
constexpr int kCSlab = kSlots * kDepth * 2;  // bytes of a C slab

// The stages of a ring: resident X, four C stages and two blocks an SM;
// streamed X, six X + C stages and one block.
template <bool kStream>
struct Plan {
  static constexpr int kStage = kCSlab + (kStream ? kXSlab : 0);
  static constexpr int kRing = kStream ? 6 : 4;
  static constexpr int kBlocks = kStream ? 1 : 2;
};

__host__ __device__ inline int pad_features(int d) {
  return cdiv(d, kStep) * kStep;
}
// Whether X streams at width d (past the resident tile).
__host__ __device__ inline bool streams(int d) {
  return pad_features(d) > kResident;
}
__host__ __device__ inline int pad_slots(int k) {
  return cdiv(k, kSlots) * kSlots;
}

// Floats of scratch one launch needs: the packed bf16 C, then |c|^2.
__host__ inline long long scratch_floats(int r, int k, int d) {
  return (long long)r * pad_slots(k) * (pad_features(d) / 2 + 1);
}

// Shared bytes of a launch: slack to align the slabs to 1024 bytes (the
// 128-byte swizzle's period), the resident X slabs or none, the ring, and
// its full and empty mbarriers.
template <bool kStream>
__host__ inline size_t smem_bytes(int dp) {
  using P = Plan<kStream>;
  return 1024 + (kStream ? 0 : (size_t)cdiv(dp, kDepth) * kXSlab) +
         (size_t)P::kRing * P::kStage + 2 * sizeof(uint64_t) * P::kRing;
}

// C (r * k rows of d) -> cb (r, k_pad, dp), zero past k and d, and csq
// (r, k_pad): |c|^2 as row_sqnorms computes it (a warp a row, lanes
// striding the row, a fixed shuffle tree; the zeros past d add exactly
// nothing), +inf past k.
__global__ void __launch_bounds__(256)
pack_c(const bf16* __restrict__ c, int r, int k, int d, int k_pad, int dp,
       bf16* __restrict__ cb, float* __restrict__ csq) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)r * k_pad) return;
  const int slot = (int)(row % k_pad);
  const bool real = slot < k;
  const bf16* src = c + (row / k_pad * k + slot) * d;
  bf16* dst = cb + row * dp;
  float s = 0.f;
  for (int j = lane; j < dp; j += 32) {
    const bf16 v = real && j < d ? src[j] : __ushort_as_bfloat16(0);
    dst[j] = v;
    const float f = __bfloat162float(v);
    s = fmaf(f, f, s);
  }
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) csq[row] = real ? s : INFINITY;
}

// Byte offset of 16-byte group g (features 8g .. 8g+7) of row i in a slab
// of 128-byte lines with the 128-byte swizzle, as TMA lays a box.
__device__ __forceinline__ int swz(int i, int g) {
  return i * 128 + ((g ^ (i & 7)) << 4);
}

// 16-byte unit u of a slab (row u / 8, features f0 + 8 (u % 8) .. + 7) of
// X (xt: the first row, row-major, d columns): zero at or past row `rows`
// and past d.
__device__ __forceinline__ uint4 load_unit(const bf16* xt, int rows, int d,
                                           int f0, int u) {
  const int i = u >> 3, f = f0 + 8 * (u & 7);
  if (i >= rows || f >= d) return make_uint4(0, 0, 0, 0);
  const bf16* src = xt + (int64_t)i * d + f;
  if (f + 8 <= d && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return __ldcs(reinterpret_cast<const uint4*>(src));
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
  unsigned e[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) e[q] = f + q < d ? __ldcs(s16 + q) : 0u;
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                    e[6] | e[7] << 16);
}

// Features [f0, f0 + kDepth) of kR rows of X into a swizzled slab (rows
// at or past `rows` and features past d zero), by kT threads (this one
// t), kB units a thread at a time: a batch's loads all issue before its
// stores, so their latencies overlap.
template <int kR, int kT, int kB>
__device__ __forceinline__ void fill_slab(char* slab, const bf16* xt,
                                          int rows, int d, int f0, int t) {
  constexpr int kUnits = kR * 8 / kT;   // a thread's units
  static_assert(kUnits % kB == 0, "whole batches");
#pragma unroll 1
  for (int b = 0; b < kUnits; b += kB) {
    uint4 v[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j)
      v[j] = load_unit(xt, rows, d, f0, t + (b + j) * kT);
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int u = t + (b + j) * kT;
      *reinterpret_cast<uint4*>(slab + swz(u >> 3, u & 7)) = v[j];
    }
  }
}

// Row i's |x|^2 chain over the first `groups` 16-byte groups of a slab.
__device__ __forceinline__ float chain(const char* slab, int i, int groups) {
  float s = 0.f;
  for (int g = 0; g < groups; ++g) {
    const uint4 v = *reinterpret_cast<const uint4*>(slab + swz(i, g));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float lo = __uint_as_float(w[q] << 16);
      const float hi = __uint_as_float(w[q] & 0xffff0000u);
      s = fmaf(lo, lo, s);
      s = fmaf(hi, hi, s);
    }
  }
  return s;
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart; a k16 step within the line adds 32 bytes.
__device__ __forceinline__ uint64_t desc_of(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A (64 x 16, desc a) x B (128 x 16, desc b)^T; scale_d 0 starts
// from zero.  A warpgroup's 128 threads issue it
// together.  Thread t holds rows lo = 16 (t / 32) + (t % 32) / 4 and lo + 8
// and columns 8j + 2 (t % 4) + {0, 1}: d[4j + e] is row lo + 8 (e / 2),
// column 8j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
// Keeps the compiler from touching the accumulator across the wgmma's
// asynchronous window (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Commits the warpgroup's issued wgmma and waits until they are done.
__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy stores to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A barrier of the 128 threads of one consumer warpgroup (ids 1 and 2).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// One distance of the epilogue: the reference's max(|x|^2 - 2 x.c +
// |c|^2, 0) with NaN kept, keyed by its bits + 1 as a signed int (NaN
// lowest, then the value).
__device__ __forceinline__ int dist_key(float cross, float xn, float cn) {
  float v = __fadd_rn(__fmaf_rn(-2.f, cross, xn), cn);
  asm("max.NaN.f32 %0, %0, 0f00000000;" : "+f"(v));
  return (int)(__float_as_uint(v) + 1u);
}
constexpr int kNoKey = 0x7fffffff;   // above every key: no distance yet
__device__ __forceinline__ float key_dist(int key) {
  return __uint_as_float((unsigned)key - 1u);
}

// One distance into a row's running (key, index).  The strictly smaller
// key wins, so the first of equal keys stays.
__device__ __forceinline__ void take(float cross, float xn, float cn,
                                     int col, int& key, int& arg) {
  const int kv = dist_key(cross, xn, cn);
  if (kv < key) {
    key = kv;
    arg = col;
  }
}

// A warpgroup's cross terms against a chunk (the accumulator) folded
// into its rows' running (key, index); cn: |c|^2 of the chunk's slots, c0
// the first.
__device__ __forceinline__ void fold(const float (&cross)[64], const float* cn,
                                     int c0, int quad, const float (&xn)[2],
                                     int (&key)[2], int (&arg)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * quad;
    const float2 cv = __ldg(reinterpret_cast<const float2*>(cn + col));
    take(cross[4 * j], xn[0], cv.x, c0 + col, key[0], arg[0]);
    take(cross[4 * j + 1], xn[0], cv.y, c0 + col + 1, key[0], arg[0]);
    take(cross[4 * j + 2], xn[1], cv.x, c0 + col, key[1], arg[1]);
    take(cross[4 * j + 3], xn[1], cv.y, c0 + col + 1, key[1], arg[1]);
  }
}

// A measurement: a warpgroup's cross terms against a chunk into out rows
// (n, k) (row lo of the warpgroup at `first`; rows from `rows` on and
// slots past k are not written).
__device__ __forceinline__ void store_cross(const float (&cross)[64],
                                            float* out, int first, int lo,
                                            int rows, int c0, int quad,
                                            int k) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = first + lo + 8 * (e / 2);
      const int col = c0 + 8 * j + 2 * quad + e % 2;
      if (row < rows && col < k)
        out[(int64_t)row * k + col] = cross[4 * j + e];
    }
}

// The bounded step's operands (bounds_tc), each problem after the other:
// the standing labels lab0 (R, N), the squared lower bounds lb (R, N, G)
// of the G groups of gs contiguous centroids (gs a multiple of 8), the
// squared upper bounds ub (R, N); outputs the group minima gmin (R, N, G)
// and each 64-row tile's count of skipped groups part_skip (R, cdiv(N,
// 64)).
struct Bounds {
  const int* lab0;
  const float* lb;
  const float* ub;
  int gs, g;
  float* gmin;
  int* part_skip;
};

constexpr int kTileRows = 64;   // the skip test's tile: one warpgroup's rows

// Shared words of the bounded form beside the ring: the block's ub^2, the
// two tiles' need bits, the list (a bit a chunk that either tile needs)
// and each tile's block masks (16 bits a chunk: block j of the chunk is
// in a group the tile computes), for G groups and n_chunks chunks.
__host__ __device__ inline int bounds_words(int g, int n_chunks) {
  return kRows + 2 * need_words(g) + need_words(n_chunks) + n_chunks;
}

// The skip test of the bounded step, by all the block's threads: warpgroup
// w tests its tile (the block's rows 64w .. 64w+63) into need + w * nw,
// writes its skipped count and passes each skipped cell's lb^2 to gmin;
// then the block masks (masks[w * n_chunks + c]: bit j where block j of
// chunk c, columns 8j .. 8j+7, lies in a group that tile w computes) and
// the list: a bit in `listed` for each chunk that either tile needs.
// ub_s: the rows' ub^2.  -> the listed chunks.
__device__ __forceinline__ int skip_test(const Bounds& bd, int r, int n,
                                         int n_chunks, int64_t row0,
                                         int rows, float* ub_s,
                                         unsigned* need, unsigned* listed,
                                         uint16_t* masks) {
  const int g = bd.g, nw = need_words(g), cw = need_words(n_chunks);
  const int64_t at = (int64_t)r * n + row0;   // the block's first row
  for (int e = threadIdx.x; e < 2 * nw + cw; e += kThreads) need[e] = 0u;
  if (threadIdx.x < kRows)
    ub_s[threadIdx.x] = threadIdx.x < rows ? bd.ub[at + threadIdx.x] : 0.f;
  __syncthreads();
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const int mine = kTileRows * w;
  const int cells = min(max(rows - mine, 0), kTileRows) * g;
  const float* const lbt = bd.lb + (at + mine) * g;
  unsigned* const need_w = need + w * nw;
  // cell e = t + 128 i is row e / g, group e % g: stepped, not divided.
  // With G <= 32 every bit is in word 0: a warp ORs its lanes' bits first.
  const int q_step = 128 / g, r_step = 128 % g;
  auto next_cell = [&](int& row, int& grp) {
    row += q_step;
    grp += r_step;
    if (grp >= g) {
      grp -= g;
      ++row;
    }
  };
  int row_t = t / g, grp_t = t % g;
  for (int e0 = 0; e0 < cells; e0 += 128) {
    const int e = e0 + t, row = row_t, grp = grp_t;
    next_cell(row_t, grp_t);
    const bool hit = e < cells && lbt[e] <= ub_s[mine + row];
    if (g <= 32) {
      const unsigned bits =
          __reduce_or_sync(0xffffffffu, hit ? 1u << grp : 0u);
      if (t % 32 == 0 && bits) atomicOr(need_w, bits);
    } else if (hit) {
      atomicOr(&need_w[grp >> 5], 1u << (grp & 31));
    }
  }
  __syncthreads();
  if (t == 0 && cells > 0) {
    int on = 0;   // computed groups
    for (int q = 0; q < nw; ++q) on += __popc(need_w[q]);
    bd.part_skip[(int64_t)r * cdiv(n, kTileRows) + 2 * blockIdx.x + w] =
        g - on;
  }
  float* const gmint = bd.gmin + (at + mine) * g;
  row_t = t / g;
  grp_t = t % g;
  for (int e0 = 0; e0 < cells; e0 += 128) {
    const int e = e0 + t, grp = grp_t;
    next_cell(row_t, grp_t);
    if (e < cells && !bit(need_w, grp)) gmint[e] = lbt[e];
  }
  // a thread a (tile, chunk); block j's group stepped, not divided
  for (int e = threadIdx.x; e < 2 * n_chunks; e += kThreads) {
    const int c = e % n_chunks;
    const unsigned* const need_t = need + e / n_chunks * nw;
    int grp = c * kSlots / bd.gs, off = c * kSlots - grp * bd.gs;
    unsigned m = 0;
    for (int j = 0; j < kSlots / 8; ++j) {
      if (grp < g && bit(need_t, grp)) m |= 1u << j;
      off += 8;
      if (off == bd.gs) {
        off = 0;
        ++grp;
      }
    }
    masks[e] = (uint16_t)m;
    if (m) atomicOr(listed + (c >> 5), 1u << (c & 31));
  }
  __syncthreads();
  int n_lists = 0;
  for (int q = 0; q < cw; ++q) n_lists += __popc(listed[q]);
  return n_lists;
}

// One 128-row tile of X a block (blockIdx.x), one problem a grid row
// (blockIdx.y): each row's label and min distance against the k centroids
// of its problem (cmap: the packed cb as (dp, k_pad, r); csq: their
// |c|^2, k_pad a problem).  kStream: X streams through the ring (by TMA
// through xmap where tma_x, else each warpgroup stores its rows of each
// slab); else each warpgroup stores its rows once.  kCross (a
// measurement): each row's cross terms x.c go to out (R, n, k) instead of
// labels and distances.  kBounded: the bounded step with bd's bounds (the
// file's header): only the listed chunks are swept, the seed (ub^2, lab0)
// merges last, and the group minima go to bd.gmin.
template <bool kStream, bool kCross, bool kBounded>
__device__ __forceinline__ void sweep(
    const CUtensorMap& cmap, const CUtensorMap& xmap,
    const bf16* __restrict__ x, int64_t x_rstride, int tma_x,
    const float* __restrict__ csq, int n, int k, int d,
    int* __restrict__ labels, float* __restrict__ mind,
    float* __restrict__ out, const Bounds& bd) {
  using P = Plan<kStream>;
  constexpr int kRing = P::kRing, kStage = P::kStage;
  extern __shared__ float4 smem_raw[];
  const unsigned base = smem_addr(smem_raw);
  char* const sm =
      reinterpret_cast<char*>(smem_raw) + (1024 - base % 1024) % 1024;
  const int dp = pad_features(d), n_slabs = cdiv(dp, kDepth);
  const int k_pad = pad_slots(k), n_chunks = k_pad / kSlots;
  char* const xres = sm;                                   // !kStream
  char* const ring = sm + (kStream ? 0 : n_slabs * kXSlab);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kRing * kStage);
  uint64_t* const empty = full + kRing;
  // kBounded: the words of skip_test after the mbarriers
  float* const ub_s = reinterpret_cast<float*>(empty + kRing);
  const int nw = kBounded ? need_words(bd.g) : 0;
  unsigned* const need = reinterpret_cast<unsigned*>(ub_s + kRows);
  unsigned* const listed = need + 2 * nw;
  uint16_t* const masks = reinterpret_cast<uint16_t*>(
      listed + (kBounded ? need_words(n_chunks) : 0));

  const int r = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int rows = n - row0 < kRows ? (int)(n - row0) : kRows;
  const bf16* const xt = x + r * x_rstride + row0 * d;
  const int xr = x_rstride ? r : 0;   // X's problem coordinate
  int n_lists = n_chunks;             // the chunks the block sweeps
  if constexpr (kBounded)
    n_lists = skip_test(bd, r, n, n_chunks, row0, rows, ub_s, need, listed,
                        masks);
  // kBounded: what decides which chunk comes next and which slots its
  // epilogue reads is the same in every lane; through a warp reduction
  // (REDUX, into a uniform register) ptxas sees it so and keeps the
  // accumulator's reads on a uniform path (read from shared memory, the
  // branches on it serialized every wgmma)
  auto uniform = [](unsigned v) { return __reduce_or_sync(0xffffffffu, v); };
  const int n_stages = n_lists * n_slabs;
  // kBounded: the chunk of the next stage thread 0 starts
  int next_c = kBounded ? next_set(listed, 0, n_chunks) : 0;
  // stage s (list position s / n_slabs, slab s % n_slabs) into its ring
  // slot, by thread 0: C's box and, where it comes by TMA, X's
  auto start_stage = [&](int s) {
    const int slot = s % kRing, q = s % n_slabs;
    char* const st = ring + slot * kStage;
    int chunk = s / n_slabs;
    if constexpr (kBounded) {
      chunk = next_c;
      if (q == n_slabs - 1) next_c = next_set(listed, next_c + 1, n_chunks);
    }
    mbar_expect(full + slot, kCSlab + (kStream && tma_x ? kXSlab : 0));
    tma3(st, &cmap, q * kDepth, chunk * kSlots, r, full + slot);
    if (kStream && tma_x)
      tma3(st + kCSlab, &xmap, q * kDepth, (int)row0, xr, full + slot);
  };
  // once the block has left stage s - 1, its slot takes stage s - 1 + kRing
  auto refill = [&](int s) {
    if (threadIdx.x != 0 || s < 1 || s - 1 + kRing >= n_stages) return;
    mbar_wait(empty + (s - 1) % kRing, ((s - 1) / kRing) & 1);
    start_stage(s - 1 + kRing);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i);
      mbar_init<8>(empty + i);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kRing && s < n_stages; ++s) start_stage(s);
  }
  __syncthreads();

  // Warpgroup w owns rows 64w .. 64w+63; thread t holds rows lo and lo + 8
  // of them (wgmma's accumulator layout).
  const int w = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32, quad = lane & 3;
  const int lo = 16 * (t / 32) + lane / 4;
  const int mine = 64 * w;   // the warpgroup's first row
  // lanes 0 and 1 of each quad carry the |x|^2 chains of rows lo, lo + 8
  const bool chains = (lane & 2) == 0;
  const int chain_row = mine + lo + 8 * (lane & 1);
  float xsq = 0.f, xn[2];
  int key[2] = {kNoKey, kNoKey}, arg[2] = {0, 0};
  auto share_xsq = [&]() {
    xn[0] = __shfl_sync(0xffffffffu, xsq, lane & ~3);
    xn[1] = __shfl_sync(0xffffffffu, xsq, (lane & ~3) | 1);
  };
  const float* const cn = csq + (int64_t)r * k_pad;
  float* const out_r = kCross ? out + (int64_t)r * n * k + row0 * k : nullptr;
  // kBounded: the tile's block masks, the first listed chunk (n_chunks:
  // none), and the running minimum keys of rows lo, lo + 8 in the open
  // group gcur (-1: none yet)
  const uint16_t* const masks_w = masks + w * n_chunks;
  const int first = kBounded ? uniform(next_set(listed, 0, n_chunks)) : 0;
  int gkey[2] = {kNoKey, kNoKey}, gcur = -1;
  float* const gmin_r = kBounded ? bd.gmin + ((int64_t)r * n + row0) * bd.g
                                 : nullptr;
  // the open group's minima over the quad, by its lane 0
  auto close_group = [&]() {
    if (gcur < 0) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = gkey[h];
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int row = mine + lo + 8 * h;
      if (quad == 0 && row < rows)
        gmin_r[(int64_t)row * bd.g + gcur] = key_dist(v);
    }
  };
  // the open group becomes grp (closing the one before), if it is not yet
  auto open_group = [&](int grp) {
    if (grp != gcur) {
      close_group();
      gcur = grp;
      gkey[0] = gkey[1] = kNoKey;
    }
  };
  // The bounded epilogue of a chunk's cross terms, slots c0 on.  Block j
  // (columns 8j .. 8j+7) lies in one group; on: bit j where the tile
  // computes that group (a slot of a skipped group gets no key).  Each
  // form is one straight pass of take() where it can be (branching on
  // each block cuts a pass into 16 short runs with little to overlap):
  //  - the chunk in one group (most chunks where gs >= 128): the group
  //    opens first, and each key goes into its minimum;
  //  - in two groups (gs >= 64): the running minimum of the chunk's keys,
  //    the first group's kept at block `split`, where the second starts;
  //  - else two passes: the keys replace the cross terms, then the group
  //    minima take them block by block.
  auto fold_bounded = [&](float (&cross)[64], int c0) {
    const int grp0 = c0 / bd.gs, off0 = c0 - grp0 * bd.gs;
    const unsigned on = uniform(masks_w[c0 / kSlots]);
    const int split = (bd.gs - off0) / 8;   // the second group's first block
    // one key of the straight passes: take() where block j is computed
    // (masked: where some block is not)
    auto key_at = [&](int j, int e, float2 cv, bool masked) {
      const int h = e / 2;
      int kv = dist_key(cross[4 * j + e], xn[h], e % 2 ? cv.y : cv.x);
      if (masked) kv = (on >> j) & 1u ? kv : kNoKey;
      if (kv < key[h]) {
        key[h] = kv;
        arg[h] = c0 + 8 * j + 2 * quad + e % 2;
      }
      return kv;
    };
    if (uniform(split >= 16)) {
      if (on) open_group(grp0);
      // a copy for the whole chunk computed, without the masks
      auto pass = [&](bool masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 cv = __ldg(
              reinterpret_cast<const float2*>(cn + c0 + 8 * j + 2 * quad));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gkey[e / 2] = min(gkey[e / 2], key_at(j, e, cv, masked));
        }
      };
      if (uniform(on == 0xffffu))
        pass(false);
      else
        pass(true);
      return;
    }
    if (uniform(split + bd.gs / 8 >= 16)) {
      int gk[2] = {kNoKey, kNoKey}, head[2] = {kNoKey, kNoKey};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool at = j == split;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          head[h] = at ? gk[h] : head[h];
          gk[h] = at ? kNoKey : gk[h];
        }
        const float2 cv = __ldg(
            reinterpret_cast<const float2*>(cn + c0 + 8 * j + 2 * quad));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          gk[e / 2] = min(gk[e / 2], key_at(j, e, cv, true));
      }
      const unsigned first = uniform((1u << split) - 1u);
      if (on & first) {
        open_group(grp0);
#pragma unroll
        for (int h = 0; h < 2; ++h) gkey[h] = min(gkey[h], head[h]);
      }
      if (on & ~first) {
        open_group(grp0 + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) gkey[h] = min(gkey[h], gk[h]);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 cv = __ldg(
          reinterpret_cast<const float2*>(cn + c0 + 8 * j + 2 * quad));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cross[4 * j + e] = __int_as_float(key_at(j, e, cv, true));
    }
    int grp = grp0, off = off0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if ((on >> j) & 1u) {
        open_group(grp);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          gkey[h] = min(gkey[h],
                        min(__float_as_int(cross[4 * j + 2 * h]),
                            __float_as_int(cross[4 * j + 2 * h + 1])));
      }
      off += 8;
      if (off == bd.gs) {
        off = 0;
        ++grp;
      }
    }
  };
  // the epilogue of a chunk's cross terms, slots c0 on (kBounded: the
  // cross terms are spent)
  auto finish = [&](float (&cross)[64], int c0) {
    if constexpr (kCross)
      store_cross(cross, out_r, mine, lo, rows, c0, quad, k);
    else if constexpr (kBounded)
      fold_bounded(cross, c0);
    else
      fold(cross, cn + c0, c0, quad, xn, key, arg);
  };

  if constexpr (!kStream) {
    // the warpgroup's rows once, all slabs (kBounded: if the block sweeps
    // any)
    if (!kBounded || first < n_chunks) {
      for (int q = 0; q < n_slabs; ++q)
        fill_slab<64, 128, 4>(xres + q * kXSlab + mine * 128,
                              xt + (int64_t)mine * d,
                              min(max(rows - mine, 0), 64), d, q * kDepth, t);
      fence_async_shared();
      warpgroup_sync(1 + w);
      if (chains)
        for (int q = 0; q < n_slabs; ++q)
          xsq = __fadd_rn(xsq, chain(xres + q * kXSlab, chain_row,
                                     min(kDepth, dp - q * kDepth) / 8));
      share_xsq();
    }
  }
  // A chunk's products over its slabs, one stage a slab: resident X into
  // one accumulator; streamed X into a fresh one each stage, added into
  // the chunk's f32 total once done (the promotion).  kBounded: the
  // listed chunks in order.
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0, s = 0, listed_c = first; c < n_lists; ++c) {
    const int chunk = kBounded ? listed_c : c;
    for (int q = 0; q < n_slabs; ++q, ++s) {
      const int slot = s % kRing;
      char* const st = ring + slot * kStage;
      char* const xs = kStream ? st + kCSlab : xres + q * kXSlab;
      refill(s);
      if (kStream && !tma_x) {
        // this warpgroup's rows of X's slab (its last reader, stage
        // s - kRing, is done)
        fill_slab<64, 128, 4>(xs + mine * 128, xt + (int64_t)mine * d,
                              min(max(rows - mine, 0), 64), d, q * kDepth,
                              t);
        fence_async_shared();
        warpgroup_sync(1 + w);
      }
      mbar_wait(full + slot, (s / kRing) & 1);
      const int steps = min(kDepth, dp - q * kDepth) / kStep;
      if (kStream && chunk == first && chains)   // |x|^2 chains
        xsq = __fadd_rn(xsq, chain(xs, chain_row, 2 * steps));
      const uint64_t da = desc_of(xs + mine * 128), db = desc_of(st);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / kStep; ++kk)
        if (kk < steps)
          wgmma(acc, da + 2 * kk, db + 2 * kk, kk > 0 || (!kStream && q > 0));
      wgmma_commit_and_wait();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + slot);
      if constexpr (kStream) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          total[i] = q == 0 ? acc[i] : __fadd_rn(total[i], acc[i]);
      }
    }
    if constexpr (kBounded)
      listed_c = uniform(next_set(listed, listed_c + 1, n_chunks));
    if (kStream && chunk == first) share_xsq();
    finish(kStream ? total : acc, chunk * kSlots);
  }
  if constexpr (kCross) return;
  if constexpr (kBounded) close_group();   // the last open group
  // the four lanes of each row, by (key, index); kBounded: then the seed
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int ok = __shfl_xor_sync(0xffffffffu, key[h], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[h], off);
      if (ok < key[h] || (ok == key[h] && oa < arg[h])) {
        key[h] = ok;
        arg[h] = oa;
      }
    }
    const int row = mine + lo + 8 * h;
    if (quad == 0 && row < rows) {
      const int64_t at = (int64_t)r * n + row0 + row;
      int lab = arg[h];
      float v = key_dist(key[h]);
      if constexpr (kBounded) {
        // the reference's rule: a distance replaces the seed when it is
        // smaller, or NaN where the seed is not
        const float seed = ub_s[row];
        if (!(key[h] != kNoKey &&
              ((isnan(v) && !isnan(seed)) || v < seed))) {
          v = seed;
          lab = bd.lab0[at];
        }
      }
      labels[at] = lab;
      mind[at] = v;
    }
  }
}

template <bool kStream, bool kCross>
__global__ void __launch_bounds__(kThreads, Plan<kStream>::kBlocks)
assign_tc(const __grid_constant__ CUtensorMap cmap,
          const __grid_constant__ CUtensorMap xmap,
          const bf16* __restrict__ x, int64_t x_rstride, int tma_x,
          const float* __restrict__ csq, int n, int k, int d,
          int* __restrict__ labels, float* __restrict__ mind,
          float* __restrict__ out) {
  sweep<kStream, kCross, false>(cmap, xmap, x, x_rstride, tma_x, csq, n, k,
                                d, labels, mind, out, Bounds{});
}

template <bool kStream>
__global__ void __launch_bounds__(kThreads, Plan<kStream>::kBlocks)
bounds_tc(const __grid_constant__ CUtensorMap cmap,
          const __grid_constant__ CUtensorMap xmap,
          const bf16* __restrict__ x, int64_t x_rstride, int tma_x,
          const float* __restrict__ csq, int n, int k, int d,
          int* __restrict__ labels, float* __restrict__ mind,
          const Bounds bd) {
  sweep<kStream, false, true>(cmap, xmap, x, x_rstride, tma_x, csq, n, k, d,
                              labels, mind, nullptr, bd);
}

// The tensor maps of a launch, after C is packed into scratch
// (scratch_floats(r, k, d) floats, 16-byte aligned) on stream s: C's
// (dp, k_pad, r) and, where X streams by TMA (*tma_x), X's; *csq: |c|^2.
template <bool kStream>
__host__ inline cudaError_t prepare(cudaStream_t s, const bf16* x,
                                    int64_t x_rstride, const bf16* c, int r,
                                    int n, int k, int d, float* scratch,
                                    CUtensorMap* cmap, CUtensorMap* xmap,
                                    bool* tma_x, const float** csq) {
  const int k_pad = pad_slots(k), dp = pad_features(d);
  bf16* const cb = reinterpret_cast<bf16*>(scratch);
  float* const cs = scratch + (int64_t)r * k_pad * dp / 2;
  *csq = cs;
  const int64_t c_rows = (int64_t)r * k_pad;
  pack_c<<<(unsigned)cdiv((int)c_rows, 8), 256, 0, s>>>(c, r, k, d, k_pad,
                                                       dp, cb, cs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint32_t c_box[3] = {kDepth, kSlots, 1};
  const uint64_t c_dims[3] = {(uint64_t)dp, (uint64_t)k_pad, (uint64_t)r};
  const uint64_t c_strides[2] = {(uint64_t)dp * 2, (uint64_t)k_pad * dp * 2};
  err = encode3(cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cb, c_dims,
                c_strides, c_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  *tma_x = kStream && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           d % 8 == 0 && x_rstride % 8 == 0;
  if (*tma_x) {
    // X (R, n, d), or one (n, d) that every problem reads
    const uint64_t x_dims[3] = {(uint64_t)d, (uint64_t)n,
                                (uint64_t)(x_rstride ? r : 1)};
    const uint64_t x_strides[2] = {
        (uint64_t)d * 2,
        (uint64_t)(x_rstride ? x_rstride : (int64_t)n * d) * 2};
    const uint32_t x_box[3] = {kDepth, kRows, 1};
    err = encode3(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, x_dims,
                  x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  return err;
}

// The sweep on stream s with X resident or streamed (kStream): C packed
// into scratch (scratch_floats(r, k, d) floats, 16-byte aligned), then
// assign_tc; with `out` (R, n, k) the cross terms instead of labels and
// distances.
template <bool kStream>
__host__ inline cudaError_t launch_plan(cudaStream_t s, const bf16* x,
                                        int64_t x_rstride, const bf16* c,
                                        int r, int n, int k, int d,
                                        float* scratch, int* labels,
                                        float* mind, float* out) {
  CUtensorMap cmap{}, xmap{};
  bool tma_x;
  const float* csq;
  cudaError_t err = prepare<kStream>(s, x, x_rstride, c, r, n, k, d, scratch,
                                     &cmap, &xmap, &tma_x, &csq);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(n, kRows), r);
  const size_t smem = smem_bytes<kStream>(pad_features(d));
  auto run = [&](auto kernel) {
    cudaError_t e = set_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, s>>>(cmap, xmap, x, x_rstride, (int)tma_x,
                                        csq, n, k, d, labels, mind, out);
    return cudaGetLastError();
  };
  return out ? run(assign_tc<kStream, true>) : run(assign_tc<kStream, false>);
}

__host__ inline cudaError_t launch(cudaStream_t s, const bf16* x,
                                   int64_t x_rstride, const bf16* c, int r,
                                   int n, int k, int d, float* scratch,
                                   int* labels, float* mind,
                                   float* out = nullptr) {
  return streams(d) ? launch_plan<true>(s, x, x_rstride, c, r, n, k, d,
                                        scratch, labels, mind, out)
                    : launch_plan<false>(s, x, x_rstride, c, r, n, k, d,
                                         scratch, labels, mind, out);
}

// The bounded step's sweep on stream s (bounds_tc), X resident or streamed
// (kStream: as launch picks it, streams(d)): C packed into scratch as
// launch_plan packs it, then labels, mind, bd.gmin and bd.part_skip.
template <bool kStream>
__host__ inline cudaError_t launch_bounds(cudaStream_t s, const bf16* x,
                                          int64_t x_rstride, const bf16* c,
                                          int r, int n, int k, int d,
                                          float* scratch, const Bounds& bd,
                                          int* labels, float* mind) {
  CUtensorMap cmap{}, xmap{};
  bool tma_x;
  const float* csq;
  cudaError_t err = prepare<kStream>(s, x, x_rstride, c, r, n, k, d, scratch,
                                     &cmap, &xmap, &tma_x, &csq);
  if (err != cudaSuccess) return err;
  const size_t smem =
      smem_bytes<kStream>(pad_features(d)) +
      sizeof(float) * bounds_words(bd.g, pad_slots(k) / kSlots);
  err = set_smem(bounds_tc<kStream>, smem);
  if (err != cudaSuccess) return err;
  bounds_tc<kStream><<<dim3(cdiv(n, kRows), r), kThreads, smem, s>>>(
      cmap, xmap, x, x_rstride, (int)tma_x, csq, n, k, d, labels, mind, bd);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace repro
