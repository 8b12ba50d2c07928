// Nearest-centroid sweep on the FP32 CUDA cores with 8 x 8 register
// blocks: one block's sweep over a 64-row X tile held whole in shared
// memory against the K centroids, C streamed through a two-stage cp.async
// ring.  The sweep of the assignment kernel, the fused step and the
// bounded fused step up to the widest resident d; past it X streams,
// through sweep_wide.cuh's sweep (the first two) or sweep_bounded.cuh's
// (the bounded step), with the same FMA chains, so the three give the same
// distances bit for bit.
//
// Why FP32 and not the tensor cores.  Split TF32 (x.c as three TF32
// products on mma.sync, C and X split into hi and lo) held f32 accuracy
// against f64 on an H100 SXM (700 W), but not the kernels' 1e-5
// agreement with the plain version at the main path's shapes: the MMA's
// truncating accumulation left min distances up to 1.49e-5 (relative to
// max(d^2, 1)) from cuBLAS's, where these FMA chains stay within 8.4e-6;
// and at 12.1 ms for all 2,458,285 x 1000 x 69 it was slower than this
// sweep (PERF.md).
//
// Numbers.  Each cross term x.c is one FMA chain over the features in
// increasing order; |x|^2 and |c|^2 are FMA chains too, and the distance
// is max(|x|^2 - 2 x.c + |c|^2, 0) (NaN passed through).  The running
// (min, argmin) uses nearest.cuh's total order (NaN first, value, index):
// the lowest index wins a tie, and the merge across lanes gives one answer
// in any order.  The unbounded scan starts at (inf, 0), centroid 0's pair
// where its distance is +inf, so a row whose every distance is +inf gets
// label 0, the first index of the minimum, and never an index >= K.
//
// Operand types.  X and C are each float32 or bfloat16 in device memory.
// Where both are bf16 the assignment and the fused step run sweep_tc.cuh's
// tensor-core sweep instead; the bounded step (any types) and the other
// two on mixed types (a bf16 X against f32 C, or the reverse, computed in
// f32 as JAX promotes them) run these FMA chains.  A bf16 value is
// converted to f32 where it is stored: X into the transposed tile
// (load_rows), C into the transposed scratch (transpose_c) and |c|^2
// (row_sqnorms).  The product of two bf16 values is exact in f32, so a
// launch with a bf16 operand equals the f32 launch on the upcast operands
// bit for bit.  The X tile holds f32, so a bf16 X takes the same path as
// an f32 X of its width.
//
// Layout.  256 threads; warp w owns rows 4w..4w+3 and 32+4w..32+4w+3 of the
// tile, and lane l slots 4l..4l+3 and 128+4l..128+4l+3 of each 256-slot
// chunk: an 8 x 8 block of cross terms per thread, fed per feature by two
// float4 loads of X (one address across the warp) and two of C
// (consecutive across the warp), 64 FMAs to 4 shared loads.  X is stored
// transposed (xs[feature][row]).  C is transposed once per launch
// (transpose_c) to (d, K padded to 256) in device memory, so a chunk is 64
// vectors of 4 consecutive centroids per feature, copied as 16-byte
// cp.async vectors while the previous stage is multiplied.  A stage is dc
// features of a chunk.
//
// Resident X.  The tile holds xs[feature][row] for all d features, loaded
// once (load_rows); dc (stage_depth) is 32 where two blocks fit on an SM
// (d = 69: 85 KB), less for wider rows, down to 4 at the widest tile that
// fits the 227 KB of a block (max_features: 821 on an H100 for the
// assignment).  Past that, or when a launcher forces it, X streams:
// launch_assign (sweep_wide.cuh) runs sweep_wide.cuh's kernel, and
// fused_bounds.cu sweep_bounded.cuh's.
//
// The unbounded sweep's chunk c is centroids 256c .. 256c+255.  The bounded
// sweep (kBounded) computes only the centroid groups its tile needs: chunk
// c is the "live" vectors 64c .. 64c+63, those holding a centroid of a
// computed group, in increasing order, listed a chunk ahead of the sweep
// (Skip::fill) into a window of two chunks, so that the shared memory does
// not grow with K.  A live vector's centroids of skipped groups (and those
// past K) are padding slots: they are copied but never compete.  So the
// ring holds only computed groups, with any group size, and every copy is
// 16 bytes.
#pragma once

#include <stdint.h>

#include "async_copy.cuh"
#include "nearest.cuh"

namespace repro {
namespace f8 {

constexpr int kThreads = 256;
constexpr int kRows = 64;           // X rows per tile
constexpr int kCents = 256;         // centroid slots per C chunk
constexpr int kVecs = kCents / 4;   // 16-byte vectors per chunk and feature
constexpr int kXLd = kRows + 4;     // pitch of the transposed X tile
constexpr int kCLd = kCents + 4;    // pitch of a staged C feature row
constexpr int kMaxDepth = 32;       // most features per C stage
constexpr int kTwoPerSm = 115712;   // shared bytes with room for two blocks

__host__ __device__ inline int pad_centroids(int k) {
  return cdiv(k, kCents) * kCents;
}

// C (r * k rows of d, float32 or bfloat16) -> ct (r, d, pad_centroids(k))
// in f32: feature-major, zero past k.
template <typename TC>
__global__ void __launch_bounds__(256)
transpose_c(const TC* __restrict__ c, int r, int k, int d, int k_pad,
            float* __restrict__ ct) {
  const int64_t total = (int64_t)r * d * k_pad;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int kk = (int)(e % k_pad);
    const int64_t row = e / k_pad;
    const int j = (int)(row % d);
    const int64_t rr = row / d;
    ct[e] = kk < k ? to_f32(c[(rr * k + kk) * d + j]) : 0.f;
  }
}

// Floats of scratch one launch needs: C transposed, then |c|^2.
__host__ inline long long scratch_floats(int r, int k, int d) {
  return (long long)r * d * pad_centroids(k) + (long long)r * k;
}

// On stream s: C transposed into the head of scratch (ct) and |c|^2 after
// it (csq), both f32 and returned through the out pointers.
template <typename TC>
__host__ inline cudaError_t prepare_c(cudaStream_t s, const TC* c, int r,
                                      int k, int d, float* scratch,
                                      float** ct, float** csq) {
  const int k_pad = pad_centroids(k);
  const int64_t ct_floats = (int64_t)r * d * k_pad;
  *ct = scratch;
  *csq = scratch + ct_floats;
  const int64_t rows = (int64_t)r * k;
  row_sqnorms<TC><<<(unsigned)((rows + 7) / 8), repro::kThreads, 0, s>>>(
      c, rows, d, *csq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (ct_floats + 255) / 256;
  transpose_c<TC><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      c, r, k, d, k_pad, *ct);
  return cudaGetLastError();
}

// Floats of the running (min, argmin) of every thread's 8 rows, where the
// sweep keeps them in shared memory between chunks (shared_best): the
// bounded sweep does, so that its group minima have the registers.
constexpr int kBestFloats = 2 * 8 * kThreads;

// Shared floats: the C ring (2 x dc x kCLd), the transposed X tile of
// x_feats features (x_feats x kXLd), |x|^2, each row's label and min
// distance, then (shared_best) the threads' running minima, and `extra`
// floats of the kernel's own.
__host__ __device__ inline size_t smem_bytes(int x_feats, int dc,
                                             size_t extra = 0,
                                             bool shared_best = false) {
  return sizeof(float) * ((size_t)2 * dc * kCLd + (size_t)x_feats * kXLd +
                          3 * kRows + (shared_best ? kBestFloats : 0) + extra);
}

// Features per C stage of the resident path for width d: kMaxDepth, 16, 8
// or 4, the deepest with which two blocks fit on an SM, else the deepest
// that fits the `optin` bytes of one block; 0 when none does (X streams).
__host__ inline int stage_depth(int d, int optin, size_t extra = 0,
                                bool shared_best = false) {
  const size_t room[2] = {(size_t)kTwoPerSm, (size_t)optin};
  for (int p = 0; p < 2; ++p)
    for (int dc = kMaxDepth; dc >= 4; dc /= 2)
      if (smem_bytes(d, dc, extra, shared_best) <= room[p]) return dc;
  return 0;
}

// The shared memory a block may opt in to on `device`; -1 when it cannot
// be queried.
__host__ inline int optin_bytes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// Widest d of the resident path: the widest whose whole tile and `extra`
// floats fit the shared memory a block may opt in to on `device` (821 on an
// H100 for the assignment); -1 when it cannot be queried.  Wider rows
// stream.
__host__ inline int max_features(int device, size_t extra = 0,
                                 bool shared_best = false) {
  const int optin = optin_bytes(device);
  if (optin < 0) return -1;
  int d = 0;
  while (smem_bytes(d + 1, 4, extra, shared_best) <= (size_t)optin) ++d;
  return d;
}

// How one launch sweeps width d: the resident tile with stage depth dc
// and smem shared bytes wherever it fits and streaming is not forced, else
// X streams (stream; the streamed kernels size themselves).  Depends on
// (d, extra, device) only, so a relaunch takes the same path.
struct SweepPlan {
  int dc;
  bool stream;
  size_t smem;
};

__host__ inline cudaError_t plan_sweep(int d, size_t extra, bool shared_best,
                                       bool force_stream, SweepPlan* plan) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int optin = optin_bytes(device);
  if (optin < 0) return cudaErrorInvalidValue;
  plan->dc = force_stream ? 0 : stage_depth(d, optin, extra, shared_best);
  plan->stream = plan->dc == 0;
  plan->smem = plan->stream ? 0 : smem_bytes(d, plan->dc, extra, shared_best);
  return cudaSuccess;
}

struct Tile {
  float* ring;      // 2 x dc x kCLd, first: 16-byte copies land here
  float* xs;        // x_feats x kXLd: xs[feature * kXLd + row], zero past
                    // the rows
  float* xsq;       // kRows
  float* mind;      // kRows
  int* lab;         // kRows
  float* best;      // (shared_best) 8 x kThreads: [i * kThreads + thread]
  int* arg;         // (shared_best) 8 x kThreads
  float* extra;     // the kernel's own floats
  __device__ Tile(float* base, int x_feats, int dc,
                  bool shared_best = false) {
    ring = base;
    xs = ring + 2 * dc * kCLd;
    xsq = xs + (size_t)x_feats * kXLd;
    mind = xsq + kRows;
    lab = reinterpret_cast<int*>(mind + kRows);
    best = reinterpret_cast<float*>(lab + kRows);
    arg = reinterpret_cast<int*>(best + kBestFloats / 2);
    extra = best + (shared_best ? kBestFloats : 0);
  }
};

// Rows [row0, row0 + rows) of X (row-major, d columns, float32 or
// bfloat16) into the transposed f32 tile, zero past the rows; then |x|^2 per
// row (threads 0-63), an FMA chain over the columns in increasing order.
// Ends with __syncthreads().
template <typename TX>
__device__ void load_rows(const Tile& sm, const TX* __restrict__ x,
                          int64_t row0, int rows, int d) {
  const TX* src = x + row0 * d;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, col = e - r * d;
    sm.xs[col * kXLd + r] = to_f32(src[e]);
  }
  for (int e = threadIdx.x; e < (kRows - rows) * d; e += kThreads) {
    const int r = rows + e / d, col = e % d;
    sm.xs[col * kXLd + r] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    float s = 0.f;
#pragma unroll 8
    for (int col = 0; col < d; ++col) {
      const float v = sm.xs[col * kXLd + threadIdx.x];
      s = fmaf(v, v, s);
    }
    sm.xsq[threadIdx.x] = s;
  }
  __syncthreads();
}

constexpr int kWarps = kThreads / 32;
// Shared words of Skip's lists: the window of two chunks' live vectors,
// each warp's count and the scan's cursor.
constexpr int kListWords = 2 * kVecs + kWarps + 1;

// What the bounded sweep computes of one tile.  Group grp holds centroids
// [grp * gs, min((grp + 1) * gs, k)); bit grp of `need` is set when the
// tile computes it.  Vector v is centroids 4v .. 4v+3; it is live when it
// holds a centroid of a computed group.
struct Skip {
  const unsigned* need;
  int* live;        // 2 x kVecs: chunk c's live vectors at (c & 1) * kVecs
  int* scan;        // kWarps counts, then the first vector not yet scanned
                    // (0 before the first fill)
  bool all;         // every group is computed: vector i of chunk c is
                    // 64c + i, and nothing is listed
  int k;
  int gs;           // centroids per group, any value >= 1
  int g;            // number of groups, cdiv(k, gs)
  unsigned* open;   // kRows: the minimum so far (key_of) of a group that
                    // goes on into the next chunk
  float* gmin;      // (rows, g) group minima of the tile's rows
  int rows;         // rows of the tile that hold data

  __device__ bool needed(int grp) const {
    return (need[grp >> 5] >> (grp & 31)) & 1u;
  }
  // Vector i of chunk c (listed, or all).
  __device__ int vec(int c, int i) const {
    return all ? c * kVecs + i : live[(c & 1) * kVecs + i];
  }
  __device__ bool vec_live(int v) const {
    const int g1 = (min(4 * v + 4, k) - 1) / gs;
    for (int grp = 4 * v / gs; grp <= g1; ++grp)
      if (needed(grp)) return true;
    return false;
  }
  // Lists chunk c, the next (up to) kVecs live vectors from the cursor on,
  // at live + (c & 1) * kVecs, and returns how many: a thread a vector,
  // ranked by a ballot in its warp and the counts of the warps before it.
  // Called by every thread, in chunk order, once chunk c - 2's list is no
  // longer read (its first barrier comes before any write); ends with
  // __syncthreads() when it scans.
  __device__ int fill(int c) const {
    const int nv = cdiv(k, 4);
    if (all) return max(0, min(kVecs, nv - c * kVecs));
    int* dst = live + (c & 1) * kVecs;
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
    return got;
  }
  // The first computed group from grp on, or g when there is none.
  __device__ int next_needed(int grp) const {
    while (grp < g) {
      const unsigned word = need[grp >> 5] >> (grp & 31);
      if (word) return grp + __ffs(word) - 1;
      grp = (grp | 31) + 1;
    }
    return g;
  }
};

// A distance (>= 0, or NaN) as an unsigned key in the order of
// nearest.cuh's pair order without index: NaN lowest, then the value.  The
// minimum of keys is order-free, so a warp reduces them in one
// __reduce_min_sync.  dist_of inverts it (NaN canonical).
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b > 0x7f800000u ? 0u : b + 1u;
}
__device__ __forceinline__ float dist_of(unsigned key) {
  return key ? __uint_as_float(key - 1u) : __uint_as_float(0x7fffffffu);
}

// The smaller of two distances, NaN first (a canonical NaN): one
// instruction.
__device__ __forceinline__ float min_nan(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// Copies of stage s (chunk s / n_ds, features (s % n_ds) * dc on, with
// n_ds = cdiv(d, dc)) into ring slot s & 1, committed as one cp.async
// group: kVecs 16-byte vectors per feature.  The bounded sweep copies the
// chunk's nv listed live vectors only: the slots past them hold stale
// values and never compete.
template <bool kBounded>
__device__ __forceinline__ void start_stage(const Tile& sm,
                                            const float* __restrict__ ct,
                                            int k, int d, int dc, int s,
                                            const Skip& skip, int nv = kVecs) {
  const int k_pad = pad_centroids(k), n_ds = cdiv(d, dc);
  const int kc = s / n_ds, d0 = (s - kc * n_ds) * dc;
  const int depth = min(dc, d - d0);
  float* dst = sm.ring + (s & 1) * dc * kCLd;
  const float* src = ct + (int64_t)d0 * k_pad;
  for (int e = threadIdx.x; e < depth * kVecs; e += kThreads) {
    const int f = e / kVecs, v = e % kVecs;
    if (kBounded) {
      if (v < nv)
        cp_async16(dst + f * kCLd + 4 * v,
                   src + (int64_t)f * k_pad + 4 * skip.vec(kc, v));
    } else {
      cp_async16(dst + f * kCLd + 4 * v,
                 src + (int64_t)f * k_pad + kc * kCents + 4 * v);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ int row_of(int ty, int i) {
  return i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4;
}

// Nearest centroid of each row of the tile against the k centroids of one
// problem, ct its transpose (d x pad_centroids(k)) and csq its norms.
// Leaves each row's (min, argmin) in sm.mind / sm.lab and ends with
// __syncthreads().  Rows past the data are computed on zeros; the caller
// ignores them.
//
// kBounded: sm.mind / sm.lab hold each row's seed (ub^2, previous label) on
// entry, and the seed wins a tie (index -1).  The caller has listed chunks
// 0 and 1 (skip.fill: n_first and n_second live vectors) and, where
// n_first > 0, started chunk 0's first stage; the sweep lists chunk c + 2
// at the end of chunk c, where the cross terms' registers are free.  Only
// the centroids of computed groups compete.  Each computed
// group's minimum over its own centroids is written to skip.gmin for the
// rows that hold data: at the end of a chunk, for each computed group that
// meets it, each lane's minimum over its slots of the group as a key
// (key_of), then one __reduce_min_sync per row; a group that goes on into
// the next chunk leaves its minimum so far in skip.open.  The distances
// overwrite the cross terms in registers, so no register holds a group's
// minimum across the FMA loop.
//
// kSharedBest (the bounded sweep's) keeps the running minima in shared
// memory between chunks (Tile(..., true)); kVecGroups (gs and K multiples
// of 4: a vector lies in one group) takes each slot's group from its
// vector and merges a chunk that lies in one group without masks; kHalf
// (at most 32 live vectors: one chunk, half full) does half the FMAs.
template <bool kBounded, bool kSharedBest = kBounded, bool kVecGroups = false,
          bool kHalf = false>
__device__ void sweep(const Tile& sm, const float* __restrict__ ct,
                      const float* __restrict__ csq, int k, int d, int dc,
                      const Skip& skip, int n_first = 0,
                      int n_second = 0) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const int n_ds = cdiv(d, dc);
  // the bounded sweep adds a chunk's stages when fill finds it
  int n_stages =
      (kBounded ? (n_first > 0) + (n_second > 0) : cdiv(k, kCents)) * n_ds;
  // live vectors of this chunk and of the next
  int n_cur = n_first, n_next = n_second;

  // row i of this thread: row_of(ty, i); slot j: tx*4 + j (j < 4),
  // 128 + tx*4 + j - 4 (j >= 4)
  float best[8];
  int arg[8];
  // kSharedBest: between chunks the running minima live in shared memory,
  // so the FMA loop has their 16 registers
  auto save_best = [&]() {
    if (!kSharedBest) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sm.best[i * kThreads + threadIdx.x] = best[i];
      sm.arg[i * kThreads + threadIdx.x] = arg[i];
    }
  };
  auto load_best = [&]() {
    if (!kSharedBest) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best[i] = sm.best[i * kThreads + threadIdx.x];
      arg[i] = sm.arg[i * kThreads + threadIdx.x];
    }
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = kBounded ? sm.mind[row_of(ty, i)] : INFINITY;
    arg[i] = kBounded ? -1 : 0;   // unbounded: (inf, 0), see the header
  }
  save_best();
  float acc[8][8];
  if (!kBounded && n_stages > 0) start_stage<false>(sm, ct, k, d, dc, 0, skip);
  for (int kc = 0; kc * n_ds < n_stages; ++kc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int ds = 0; ds < n_ds; ++ds) {
      const int s = kc * n_ds + ds, d0 = ds * dc;
      if (s + 1 < n_stages) {
        // slot (s + 1) & 1 was consumed at s - 1
        start_stage<kBounded>(sm, ct, k, d, dc, s + 1, skip,
                              ds == n_ds - 1 ? n_next : n_cur);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* xcol = sm.xs + (size_t)d0 * kXLd + ty * 4;
      const float* ccol = sm.ring + (s & 1) * dc * kCLd + tx * 4;
      const int depth = min(dc, d - d0);
      if (kHalf) {
        // the live vectors fit the first 128 slots: half the FMAs
#pragma unroll 4
        for (int kk = 0; kk < depth; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(xcol + kk * kXLd);
          const float4 a1 =
              *reinterpret_cast<const float4*>(xcol + kk * kXLd + 32);
          const float4 b0 = *reinterpret_cast<const float4*>(ccol + kk * kCLd);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < depth; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(xcol + kk * kXLd);
          const float4 a1 =
              *reinterpret_cast<const float4*>(xcol + kk * kXLd + 32);
          const float4 b0 = *reinterpret_cast<const float4*>(ccol + kk * kCLd);
          const float4 b1 =
              *reinterpret_cast<const float4*>(ccol + kk * kCLd + 128);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();            // slot s & 1 is consumed
    }
    load_best();
    if (!kBounded) {
      // The chunk's distances; a thread meets its centroids in increasing
      // order, so the pair order reduces to: smaller, or the first NaN.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col =
            kc * kCents + (j < 4 ? tx * 4 + j : 128 + tx * 4 + j - 4);
        if (col < k) {            // the ragged K edge never competes
          const float cn = csq[col];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            // |x|^2 read where it is used: in registers it would spill
            const float xn = sm.xsq[row_of(ty, i)];
            float v = __fadd_rn(xn - 2.f * acc[i][j], cn);
            v = v < 0.f ? 0.f : v;  // clamp; NaN stays NaN
            if (v < best[i] || (isnan(v) && !isnan(best[i]))) {
              best[i] = v;
              arg[i] = col;
            }
          }
        }
      }
      save_best();
      continue;
    }
    // Bounded: slot j is centroid 4 * vec + j % 4 of the thread's live
    // vectors; it competes when it lies below K in a computed group.  Its
    // distance replaces the cross term (a slot that does not compete keeps
    // a stale one, which no group minimum reads).
    const int n_in = n_cur;               // live vectors here
    const int va = tx < n_in ? skip.vec(kc, tx) : -1;
    const int vb = 32 + tx < n_in ? skip.vec(kc, 32 + tx) : -1;
    // grp[j]: slot j's group, -1 where it does not compete.  kVecGroups
    // (gs and K multiples of 4): a live vector lies in one computed group
    // and below K, so only the lanes past the chunk's live vectors idle.
    int grp[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int vec = h ? vb : va;
      if (kVecGroups) {
        const int g0 = vec >= 0 ? 4 * vec / skip.gs : -1;
#pragma unroll
        for (int q = 0; q < 4; ++q) grp[4 * h + q] = g0;
      } else {
        // one division, then a step where a group ends
        int g0 = vec >= 0 ? 4 * vec / skip.gs : 0;
        int end = (g0 + 1) * skip.gs;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 4 * vec + q;
          if (col >= end) {
            ++g0;
            end += skip.gs;
          }
          grp[4 * h + q] = vec >= 0 && col < k && skip.needed(g0) ? g0 : -1;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (grp[j] < 0) continue;
      const int col = 4 * (j < 4 ? va : vb) + (j & 3);
      const float cn = csq[col];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xn = sm.xsq[row_of(ty, i)];
        float v = __fadd_rn(xn - 2.f * acc[i][j], cn);
        v = v < 0.f ? 0.f : v;
        // strictly smaller, or the first NaN: the seed keeps a tie
        if (v < best[i] || (isnan(v) && !isnan(best[i]))) {
          best[i] = v;
          arg[i] = col;
        }
        acc[i][j] = v;
      }
    }
    save_best();
    // The group minima.  The chunk's live vectors run from centroid
    // 4 * first to 4 * last + 3; its first group may have begun in an
    // earlier chunk (its minimum so far is in skip.open) and its last one
    // may go on into the next.
    const int first = skip.vec(kc, 0), last = skip.vec(kc, n_in - 1);
    const int g_first = first * 4 / skip.gs;
    const int g_last = min(4 * last + 3, k - 1) / skip.gs;
    const bool begun = g_first * skip.gs < 4 * first;
    const bool goes_on = min((g_last + 1) * skip.gs, k) - 1 > 4 * last + 3;
    // Group g's minima m[i] of rows row_of(ty, i), the same on every lane:
    // lane i < 8 takes row i's, so it alone reads and writes that row's
    // open minimum, and the warp needs no sync.
    auto emit_lanes = [&](int g, const unsigned (&m)[8]) {
      unsigned v = m[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) v = tx == i ? m[i] : v;
      if (tx >= 8) return;
      const int row = row_of(ty, tx);
      if (begun && g == g_first) v = min(v, skip.open[row]);
      if (goes_on && g == g_last)
        skip.open[row] = v;
      else if (row < skip.rows)
        skip.gmin[(size_t)row * skip.g + g] = dist_of(v);
    };
    if (kVecGroups && g_first == g_last) {
      // the chunk lies in one group: one __reduce_min_sync a row over the
      // lanes' minima (+inf where a lane's vector is past the live ones)
      unsigned m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* a = acc[i];
        const float fa = va >= 0 ? min_nan(min_nan(a[0], a[1]),
                                           min_nan(a[2], a[3])) : INFINITY;
        const float fb = vb >= 0 ? min_nan(min_nan(a[4], a[5]),
                                           min_nan(a[6], a[7])) : INFINITY;
        m[i] = __reduce_min_sync(0xffffffffu, key_of(min_nan(fa, fb)));
      }
      emit_lanes(g_first, m);
    } else {
      // each computed group that meets the chunk in turn, the warp's
      // masked keys merged by one __reduce_min_sync a row
      for (int g = skip.next_needed(g_first); g <= g_last;
           g = skip.next_needed(g + 1)) {
        unsigned m[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float f = INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (grp[j] == g) f = min_nan(f, acc[i][j]);
          m[i] = __reduce_min_sync(0xffffffffu, key_of(f));
        }
        emit_lanes(g, m);
      }
    }
    // chunk kc's list is read: list chunk kc + 2 in its place, where chunk
    // kc + 1 is full and so may not be the last
    n_cur = n_next;
    n_next = n_cur == kVecs ? skip.fill(kc + 2) : 0;
    if (n_next > 0) n_stages += n_ds;
  }
  // Merge the 32 lanes of each row (one warp).
  load_best();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (before(ob, oa, best[i], arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
    if (tx == 0) {
      const int row = row_of(ty, i);
      sm.mind[row] = best[i];
      if (!kBounded || arg[i] >= 0) sm.lab[row] = arg[i];
    }
  }
  __syncthreads();
}

// One 64-row tile of X a block (blockIdx.x), one problem a grid row
// (blockIdx.y): each row's label and min distance, the whole tile resident.
// The assignment kernel, and the fused step's sweep, up to the widest
// resident d (sweep_wide.cuh's launch_assign picks it).
template <typename TX>
__global__ void __launch_bounds__(kThreads, 2)
assign_tiles(const TX* __restrict__ x, int64_t x_rstride,
             const float* __restrict__ ct, const float* __restrict__ csq,
             int n, int k, int d, int dc, int* __restrict__ labels,
             float* __restrict__ mind) {
  extern __shared__ float4 smem_raw[];
  const Tile sm(reinterpret_cast<float*>(smem_raw), d, dc);
  const int r = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int rows = n - row0 < kRows ? (int)(n - row0) : kRows;
  load_rows(sm, x + r * x_rstride, row0, rows, d);
  sweep<false, false>(sm, ct + (int64_t)r * d * pad_centroids(k),
                      csq + (int64_t)r * k, k, d, dc, Skip{});
  if (threadIdx.x < rows) {
    labels[(int64_t)r * n + row0 + threadIdx.x] = sm.lab[threadIdx.x];
    mind[(int64_t)r * n + row0 + threadIdx.x] = sm.mind[threadIdx.x];
  }
}

}  // namespace f8
}  // namespace repro
