// Shared device code of the kernels in this directory: one block's
// nearest-centroid sweep over an X row tile that sits in shared memory.
//
// Layout of one block (256 threads as a 16 x 16 grid, ty = tid / 16,
// tx = tid % 16):
//   * the X tile is TN = 64 rows, stored TRANSPOSED in shared memory
//     (xs[col * kXLd + row]) so that a thread's four rows ty*4 .. ty*4+3
//     are one float4;
//   * C is staged kTK = 64 centroids x kDC = 32 features at a time, also
//     transposed (cs[kk * kCLd + j]), so a thread's four centroids
//     tx*4 .. tx*4+3 are one float4;
//   * each thread accumulates a 4 x 4 block of cross terms x.c with FMAs,
//     so one feature step costs two 16-byte shared loads per 16 FMAs.
// Distances are max(|x|^2 - 2 x.c + |c|^2, 0), with NaN passed through as
// jnp.maximum / torch.clamp_min do.  The running (min, argmin) orders
// pairs by (NaN first, value, index): the lowest index wins a tie, which
// is the TPU kernel's "first index within a tile, strict < across tiles"
// rule (src/repro/kernels/fused_lloyd.py:74-86) stated without tiles.
// The order is total, so the half-warp shuffle that merges the 16 column
// threads of a row gives the same answer in any merge order.
//
// The bounded sweep (fused_bounds.cu) seeds the running min with the
// row's (ub^2, previous label) and gives the seed the index -1, so the
// order becomes (NaN first, value, not-seed, index): the seed wins a tie
// whatever its label, as the TPU kernel's strict < against the seed does
// (src/repro/kernels/fused_lloyd.py:176-181).  It visits only the k
// chunks that hold a centroid of a group the tile computes, masks the
// centroids of skipped groups, and emits each computed group's minimum.
//
// The tile geometry lives here only: each library exports the widest d
// its tile takes (max_features) and, for the slab layout, the rows per
// tile, so the Python wrappers hold no copy of it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;
constexpr int kTN = 64;            // X rows per tile
constexpr int kTK = 64;            // centroids per k tile
constexpr int kDC = 32;            // features per staged C chunk
constexpr int kXLd = kTN + 4;      // row pitch of the transposed X tile
constexpr int kCLd = kTK + 4;      // row pitch of the transposed C chunk

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Pair order of the argmin: NaN first (lowest index among NaNs), then the
// smaller value, then the lower index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

// Shared-memory carve-up.  Sizes in floats: xs d*kXLd, cs kDC*kCLd, then
// four kTN vectors (|x|^2, min distance, weight, label).
struct Smem {
  float* xs;
  float* cs;
  float* xsq;
  float* mind;
  float* w;
  int* lab;
  __device__ Smem(float* base, int d) {
    xs = base;
    cs = xs + (size_t)d * kXLd;
    xsq = cs + kDC * kCLd;
    mind = xsq + kTN;
    w = mind + kTN;
    lab = reinterpret_cast<int*>(w + kTN);
  }
};

// |c|^2 of `rows` rows of length d, one warp per row, lanes folded by a
// fixed shuffle tree (deterministic).
__global__ void row_sqnorms(const float* __restrict__ c, int64_t rows, int d,
                            float* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* cr = c + row * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s = fmaf(cr[j], cr[j], s);
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

// Load rows [row0, row0 + rows) of X (row-major, d columns) into the
// transposed tile; missing rows are zero.  Then |x|^2 per row.
__device__ void load_x_tile(const Smem& sm, const float* __restrict__ x,
                            int64_t row0, int rows, int d) {
  const float* src = x + row0 * d;
  const int total = rows * d;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / d, col = e - r * d;
    sm.xs[col * kXLd + r] = src[e];
  }
  if (rows < kTN) {
    for (int e = threadIdx.x; e < (kTN - rows) * d; e += kThreads) {
      const int r = rows + e / d, col = e % d;
      sm.xs[col * kXLd + r] = 0.f;
    }
  }
  __syncthreads();
  if (threadIdx.x < kTN) {
    float s = 0.f;
    for (int col = 0; col < d; ++col) {
      const float v = sm.xs[col * kXLd + threadIdx.x];
      s = fmaf(v, v, s);
    }
    sm.xsq[threadIdx.x] = s;
  }
  __syncthreads();
}

// One staged C chunk is kTK x kDC values, kChunk per thread: element
// e = tid + q * kThreads is centroid j = e / kDC, feature kk = e % kDC, so
// a warp reads 32 consecutive features of one centroid row.
constexpr int kChunk = kTK * kDC / kThreads;

__device__ __forceinline__ void fetch_chunk(float (&v)[kChunk],
                                            const float* __restrict__ c,
                                            int k, int d, int k0, int d0) {
  const int dc = min(kDC, d - d0);
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int j = e / kDC, kk = e % kDC;
    v[q] = (k0 + j < k && kk < dc) ? c[(int64_t)(k0 + j) * d + d0 + kk] : 0.f;
  }
}

__device__ __forceinline__ void store_chunk(const Smem& sm,
                                            const float (&v)[kChunk]) {
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const int e = threadIdx.x + q * kThreads;
    sm.cs[(e % kDC) * kCLd + e / kDC] = v[q];
  }
}

// Which centroid groups one row tile computes, for the bounded sweep.
// Group g holds centroids [g*gs, min((g+1)*gs, k)); bit g of `need` (in
// shared memory) is set when the tile computes it.
struct GroupSkip {
  const unsigned* need;
  int gs;             // centroids per group, any value >= 1
  int g;              // number of groups, cdiv(k, gs)
  float* gmin;        // (rows, g) group minima of this tile's rows
  int rows;           // rows of the tile that hold data

  __device__ bool needed(int grp) const {
    return (need[grp >> 5] >> (grp & 31)) & 1u;
  }
  // The first k chunk from kc on that holds a centroid of a computed
  // group, or n_kc when there is none.  The same in every thread.
  __device__ int next_chunk(int kc, int n_kc, int k) const {
    for (; kc < n_kc; ++kc) {
      const int g1 = (min((kc + 1) * kTK, k) - 1) / gs;
      for (int grp = kc * kTK / gs; grp <= g1; ++grp)
        if (needed(grp)) return kc;
    }
    return n_kc;
  }
};

// The smaller of two distances, NaN first.
__device__ __forceinline__ float nan_min(float a, float b) {
  return before(a, 0, b, 0) ? a : b;
}

// Nearest centroid of every row of the tile in sm.xs against the k
// centroids c (k x d, row-major) with squared norms csq.  Writes
// sm.lab / sm.mind for all kTN rows (rows past the data are computed on
// zeros and ignored by the caller).  C streams through shared memory one
// chunk at a time; the next chunk's loads are issued into registers
// before the current chunk's FMAs, so their latency overlaps the math.
// Ends with __syncthreads().
//
// kBounded: sm.mind / sm.lab hold each row's seed (ub^2, previous label)
// on entry; only the k chunks with a centroid of a computed group are
// loaded (the prefetch fetches the next such chunk), only the centroids
// of computed groups compete, and each computed group's minimum over its
// own centroids is written to skip.gmin for the rows that hold data.  A
// group that goes on into the next chunk keeps its per-thread minimum in
// `open`; the half warp merges once per group, where the group ends.
template <bool kBounded>
__device__ void sweep(const Smem& sm, const float* __restrict__ c,
                      const float* __restrict__ csq, int k, int d,
                      const GroupSkip& skip) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float best[4];
  int arg[4];
  float xn[4];
  float open[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = kBounded ? sm.mind[ty * 4 + i] : INFINITY;
    arg[i] = kBounded ? -1 : 0x7fffffff;
    xn[i] = sm.xsq[ty * 4 + i];
    open[i] = INFINITY;
  }
  const int n_d = cdiv(d, kDC);
  const int n_kc = cdiv(k, kTK);
  int kc = kBounded ? skip.next_chunk(0, n_kc, k) : 0;
  int ds = 0;
  float next[kChunk];
  if (kc < n_kc) fetch_chunk(next, c, k, d, kc * kTK, 0);
  float acc[4][4];
  while (kc < n_kc) {
    const int k0 = kc * kTK, d0 = ds * kDC;
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();                      // the previous chunk is consumed
    store_chunk(sm, next);
    __syncthreads();
    if (++ds == n_d) {
      ds = 0;
      kc = kBounded ? skip.next_chunk(kc + 1, n_kc, k) : kc + 1;
    }
    if (kc < n_kc) fetch_chunk(next, c, k, d, kc * kTK, ds * kDC);
    const int dc = min(kDC, d - d0);
    const float* xcol = sm.xs + (size_t)d0 * kXLd + ty * 4;
    const float* ccol = sm.cs + tx * 4;
#pragma unroll 4
    for (int kk = 0; kk < dc; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(xcol + kk * kXLd);
      const float4 b = *reinterpret_cast<const float4*>(ccol + kk * kCLd);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (ds != 0) continue;
    // Last chunk of this k tile: fold it into the running (min, argmin),
    // columns in increasing index.
    float v[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx * 4 + j;
      if (kj < k) {                       // the ragged K edge never competes
        const float cn = csq[kj];
        const bool live = !kBounded || skip.needed(kj / skip.gs);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i][j] = __fadd_rn(xn[i] - 2.f * acc[i][j], cn);
          v[i][j] = v[i][j] < 0.f ? 0.f : v[i][j];   // clamp; NaN stays NaN
          if (live && before(v[i][j], kj, best[i], arg[i])) {
            best[i] = v[i][j];
            arg[i] = kj;
          }
        }
      }
    }
    if (!kBounded) continue;
    // Group minima of the computed groups that meet this chunk.
    const int k1 = min(k0 + kTK, k);
    const int g0 = k0 / skip.gs;
    for (int grp = g0; grp <= (k1 - 1) / skip.gs; ++grp) {
      if (!skip.needed(grp)) continue;    // the same in every thread
      float m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = grp == g0 ? open[i] : INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        if (kj < k && kj / skip.gs == grp) {
#pragma unroll
          for (int i = 0; i < 4; ++i) m[i] = nan_min(v[i][j], m[i]);
        }
      }
      if (min((grp + 1) * skip.gs, k) > k1) {   // goes on in the next chunk
#pragma unroll
        for (int i = 0; i < 4; ++i) open[i] = m[i];
        break;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off; off >>= 1)
          m[i] = nan_min(__shfl_xor_sync(0xffffffffu, m[i], off), m[i]);
        const int row = ty * 4 + i;
        if (tx == 0 && row < skip.rows)
          skip.gmin[(size_t)row * skip.g + grp] = m[i];
        if (grp == g0) open[i] = INFINITY;
      }
    }
  }
  // Merge the 16 column threads of each row (one half warp).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (before(ob, oa, best[i], arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!kBounded || arg[i] >= 0) sm.lab[ty * 4 + i] = arg[i];
      sm.mind[ty * 4 + i] = best[i];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void nearest_centroids(
    const Smem& sm, const float* __restrict__ c, const float* __restrict__ csq,
    int k, int d) {
  sweep<false>(sm, c, csq, k, d, GroupSkip{});
}

// Byte size of the dynamic shared memory for feature width d.
__host__ inline size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)d * kXLd + kDC * kCLd + 4 * kTN);
}

// Widest d whose tile fits the shared memory a block may opt in to on
// `device` (818 on an H100); -1 when the device cannot be queried.
__host__ inline int max_features(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  const long long room = (long long)optin - (long long)smem_bytes(0);
  return room < 0 ? 0 : (int)(room / (long long)(sizeof(float) * kXLd));
}

// Opt in to more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
__host__ cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro
