// Nearest-centroid sweep on the FP32 CUDA cores with 8 x 8 register
// blocks: one block's sweep over a 64-row X tile in shared memory against
// all K centroids, C streamed through a two-stage cp.async ring.  Written
// for the assignment kernel and for the fused kernels to adopt.
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
// increasing order, as in nearest.cuh's 4 x 4 sweep, and the norms and
// the distance max(|x|^2 - 2 x.c + |c|^2, 0) (NaN passed through) are
// computed as there, so both sweeps give the same bits.  The running
// (min, argmin) uses nearest.cuh's total order (NaN first, value, index):
// the lowest index wins a tie, and the merge across lanes gives one answer
// in any order.
//
// Layout.  256 threads; warp w owns rows 4w..4w+3 and 32+4w..32+4w+3 of the
// tile, and lane l centroids 4l..4l+3 and 128+4l..128+4l+3 of each
// 256-centroid chunk: an 8 x 8 block of cross terms per thread, fed per
// feature by two float4 loads of X (one address across the warp) and two
// of C (consecutive across the warp), 64 FMAs to 4 shared loads.  X is
// stored transposed (xs[feature][row]).  C is transposed once per launch
// (transpose_c) to (d, K padded to 256) in device memory, so a stage of dc
// features x 256 centroids is dc runs of 1 KB, copied as 16-byte cp.async
// vectors while the previous stage is multiplied.  dc (stage_depth) is 32
// where two blocks fit on an SM (d = 69: 85 KB), less for wide rows, down
// to 4 at d = 821, the widest tile that fits the 227 KB of a block.
#pragma once

#include <stdint.h>

#include "async_copy.cuh"
#include "nearest.cuh"

namespace repro {
namespace f8 {

constexpr int kThreads = 256;
constexpr int kRows = 64;           // X rows per tile
constexpr int kCents = 256;         // centroids per C chunk
constexpr int kXLd = kRows + 4;     // pitch of the transposed X tile
constexpr int kCLd = kCents + 4;    // pitch of a staged C feature row
constexpr int kMaxDepth = 32;       // most features per C stage
constexpr int kTwoPerSm = 115712;   // shared bytes with room for two blocks

__host__ __device__ inline int pad_centroids(int k) {
  return cdiv(k, kCents) * kCents;
}

// C (r * k rows of d) -> ct (r, d, pad_centroids(k)): feature-major, zero
// past k.
__global__ void __launch_bounds__(256)
transpose_c(const float* __restrict__ c, int r, int k, int d, int k_pad,
            float* __restrict__ ct) {
  const int64_t total = (int64_t)r * d * k_pad;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int kk = (int)(e % k_pad);
    const int64_t row = e / k_pad;
    const int j = (int)(row % d);
    const int64_t rr = row / d;
    ct[e] = kk < k ? c[(rr * k + kk) * d + j] : 0.f;
  }
}

// Shared floats: the C ring (2 x dc x kCLd), the transposed X tile
// (d x kXLd), |x|^2, and each row's label and min distance.
__host__ __device__ inline size_t smem_bytes(int d, int dc) {
  return sizeof(float) * ((size_t)2 * dc * kCLd + (size_t)d * kXLd + 3 * kRows);
}

// Features per C stage for width d: kMaxDepth, 16, 8 or 4, the deepest with
// which two blocks fit on an SM, else the deepest that fits the `optin`
// bytes of one block; 0 when none does.
__host__ inline int stage_depth(int d, int optin) {
  const size_t room[2] = {(size_t)kTwoPerSm, (size_t)optin};
  for (int p = 0; p < 2; ++p)
    for (int dc = kMaxDepth; dc >= 4; dc /= 2)
      if (smem_bytes(d, dc) <= room[p]) return dc;
  return 0;
}

// Widest d that fits the shared memory a block may opt in to on `device`
// (821 on an H100); -1 when it cannot be queried.
__host__ inline int max_features(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int d = 0;
  while (smem_bytes(d + 1, 4) <= (size_t)optin) ++d;
  return d;
}

struct Tile {
  float* ring;      // 2 x dc x kCLd, first: 16-byte copies land here
  float* xs;        // d x kXLd: xs[feature * kXLd + row], zero past the rows
  float* xsq;       // kRows
  float* mind;      // kRows
  int* lab;         // kRows
  __device__ Tile(float* base, int d, int dc) {
    ring = base;
    xs = ring + 2 * dc * kCLd;
    xsq = xs + (size_t)d * kXLd;
    mind = xsq + kRows;
    lab = reinterpret_cast<int*>(mind + kRows);
  }
};

// Rows [row0, row0 + rows) of X (row-major, d columns) into the transposed
// tile, zero past the rows; then |x|^2 per row, an FMA chain over the
// columns in increasing order (nearest.cuh's load_x_tile).
__device__ void load_rows(const Tile& sm, const float* __restrict__ x,
                          int64_t row0, int rows, int d) {
  const float* src = x + row0 * d;
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, col = e - r * d;
    sm.xs[col * kXLd + r] = src[e];
  }
  for (int e = threadIdx.x; e < (kRows - rows) * d; e += kThreads) {
    const int r = rows + e / d, col = e % d;
    sm.xs[col * kXLd + r] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    float s = 0.f;
    for (int col = 0; col < d; ++col) {
      const float v = sm.xs[col * kXLd + threadIdx.x];
      s = fmaf(v, v, s);
    }
    sm.xsq[threadIdx.x] = s;
  }
  __syncthreads();
}

// Nearest centroid of each row of the tile against the k centroids of one
// problem, ct its transpose (d x pad_centroids(k)) and csq its norms.
// Leaves each row's (min, argmin) in sm.mind / sm.lab and ends with
// __syncthreads().  Rows past the data are computed on zeros; the caller
// ignores them.
__device__ void sweep(const Tile& sm, const float* __restrict__ ct,
                      const float* __restrict__ csq, int k, int d, int dc) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const int k_pad = pad_centroids(k);
  const int n_ds = cdiv(d, dc), n_stages = cdiv(k, kCents) * n_ds;

  // Copies of stage s (centroid chunk s / n_ds, features (s % n_ds) * dc
  // on) into ring slot s & 1: 64 16-byte vectors per feature.
  auto load_stage = [&](int s) {
    const int kc = s / n_ds, d0 = (s - kc * n_ds) * dc;
    const int depth = min(dc, d - d0);
    float* dst = sm.ring + (s & 1) * dc * kCLd;
    const float* src = ct + (int64_t)d0 * k_pad + kc * kCents;
    for (int e = threadIdx.x; e < depth * (kCents / 4); e += kThreads) {
      const int f = e / (kCents / 4), v = e % (kCents / 4);
      cp_async16(dst + f * kCLd + 4 * v, src + (int64_t)f * k_pad + 4 * v);
    }
    cp_async_commit();
  };

  // row i of this thread: ty*4 + i (i < 4), 32 + ty*4 + i - 4 (i >= 4);
  // centroid j: tx*4 + j (j < 4), 128 + tx*4 + j - 4 (j >= 4)
  float best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    arg[i] = 0x7fffffff;
  }
  float acc[8][8];
  load_stage(0);
  for (int s = 0; s < n_stages; ++s) {
    const int kc = s / n_ds, ds = s - kc * n_ds, d0 = ds * dc;
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (s + 1 < n_stages) {
      load_stage(s + 1);              // slot (s + 1) & 1 was consumed at s - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xcol = sm.xs + (size_t)d0 * kXLd + ty * 4;
    const float* ccol = sm.ring + (s & 1) * dc * kCLd + tx * 4;
    const int depth = min(dc, d - d0);
#pragma unroll 4
    for (int kk = 0; kk < depth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xcol + kk * kXLd);
      const float4 a1 = *reinterpret_cast<const float4*>(xcol + kk * kXLd + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(ccol + kk * kCLd);
      const float4 b1 =
          *reinterpret_cast<const float4*>(ccol + kk * kCLd + 128);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();              // slot s & 1 is consumed
    if (ds != n_ds - 1) continue;
    // The chunk's distances; a thread meets its centroids in increasing
    // order, so the pair order reduces to: smaller, or the first NaN.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kc * kCents + (j < 4 ? tx * 4 + j : 128 + tx * 4 + j - 4);
      if (col < k) {              // the ragged K edge never competes
        const float cn = csq[col];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // |x|^2 read where it is used: in registers it would spill
          const float xn = sm.xsq[i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4];
          float v = __fadd_rn(xn - 2.f * acc[i][j], cn);
          v = v < 0.f ? 0.f : v;  // clamp; NaN stays NaN
          if (v < best[i] || (isnan(v) && !isnan(best[i]))) {
            best[i] = v;
            arg[i] = col;
          }
        }
      }
    }
  }
  // Merge the 32 lanes of each row (one warp).
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
      const int row = i < 4 ? ty * 4 + i : 32 + ty * 4 + i - 4;
      sm.mind[row] = best[i];
      sm.lab[row] = arg[i];
    }
  }
  __syncthreads();
}

}  // namespace f8
}  // namespace repro
