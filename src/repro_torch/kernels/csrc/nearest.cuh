// Shared device code of the two kernels in this directory: one block's
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
// The tile geometry lives here only: each library exports the widest d
// its tile takes (max_features) and, for the fused kernel's slab layout,
// the rows per tile, so the Python wrappers hold no copy of it.
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

// Nearest centroid of every row of the tile in sm.xs against the k
// centroids c (k x d, row-major) with squared norms csq.  Writes
// sm.lab / sm.mind for all kTN rows (rows past the data are computed on
// zeros and ignored by the caller).  C streams through shared memory one
// chunk at a time; the next chunk's loads are issued into registers
// before the current chunk's FMAs, so their latency overlaps the math.
// Ends with __syncthreads().
__device__ void nearest_centroids(const Smem& sm, const float* __restrict__ c,
                                  const float* __restrict__ csq, int k, int d) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float best[4];
  int arg[4];
  float xn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    arg[i] = 0x7fffffff;
    xn[i] = sm.xsq[ty * 4 + i];
  }
  const int n_d = cdiv(d, kDC);
  const int n_chunks = cdiv(k, kTK) * n_d;
  float next[kChunk];
  fetch_chunk(next, c, k, d, 0, 0);
  float acc[4][4];
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int k0 = ch / n_d * kTK, d0 = ch % n_d * kDC;
    if (d0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();                      // the previous chunk is consumed
    store_chunk(sm, next);
    __syncthreads();
    if (ch + 1 < n_chunks)
      fetch_chunk(next, c, k, d, (ch + 1) / n_d * kTK, (ch + 1) % n_d * kDC);
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
    if (d0 + kDC < d) continue;
    // Last chunk of this k tile: fold it into the running (min, argmin),
    // columns in increasing index.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx * 4 + j;
      if (kj < k) {                       // the ragged K edge never competes
        const float cn = csq[kj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = __fadd_rn(xn[i] - 2.f * acc[i][j], cn);
          v = v < 0.f ? 0.f : v;          // clamp; NaN stays NaN
          if (before(v, kj, best[i], arg[i])) {
            best[i] = v;
            arg[i] = kj;
          }
        }
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
      sm.lab[ty * 4 + i] = arg[i];
      sm.mind[ty * 4 + i] = best[i];
    }
  }
  __syncthreads();
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
