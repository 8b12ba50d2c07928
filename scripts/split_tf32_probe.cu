// Split-TF32 ("3xTF32") nearest-centroid assignment on the tensor cores,
// kept as a probe beside the port: scripts/split_tf32_probe.py builds it
// with nvcc and holds it against the port's plain version and f64.  It is
// not on any path of the port: on an H100 its min distances missed the
// kernels' 1e-5 agreement with the plain version at the USCensus1990
// shape, so the assignment kernel runs FP32 FMA chains (sweep_fp32.cuh).
//
// x.c = x_hi.c_hi + (x_hi.c_lo + x_lo.c_hi) with hi = tf32(v) and
// lo = tf32(v - hi) (cvt.rna.tf32.f32): three m16n8k8 mma.sync products
// with f32 accumulation.  The two small ones share an accumulator, added
// to the large one after the last feature; each k step's large product
// starts from zero and is added with an ordinary f32 add, since the MMA's
// own accumulation truncates.  d is padded to 8 with zeros.  The norms are
// the fused kernel's (nearest.cuh).  C is split once per launch into hi
// and lo arrays (K padded to 64, d to 8) and streamed through a two-stage
// cp.async ring.  Two block shapes: Narrow (128 rows, X split once into hi
// and lo planes, d <= 208, where there are 264 or more tiles) and Wide
// (64 rows, X split as fragments are read, d <= 848).
#pragma once

#include <stdint.h>

#include "async_copy.cuh"
#include "nearest.cuh"

namespace repro {
namespace tc {

constexpr int kThreads = 256;
constexpr int kCents = 64;         // centroids per C chunk
constexpr int kStep = 8;           // features per m16n8k8 product
constexpr int kMaxDepth = 128;     // most features per staged C chunk
constexpr int kTwoPerSm = 115712;  // shared bytes that leave room for two blocks

__host__ __device__ inline int pad_features(int d) { return cdiv(d, kStep) * kStep; }
__host__ __device__ inline int pad_centroids(int k) { return cdiv(k, kCents) * kCents; }

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32, col-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C (rows, d) -> hi, lo (rows_pad, d_pad) of split TF32, rows = r * k with
// k_pad rows per problem; zero past k and past d.
__global__ void __launch_bounds__(256)
split_tf32(const float* __restrict__ c, int r, int k, int d, int k_pad,
           int d_pad, float* __restrict__ hi, float* __restrict__ lo) {
  const int64_t total = (int64_t)r * k_pad * d_pad;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(e % d_pad);
    const int64_t row = e / d_pad;
    const int kk = (int)(row % k_pad);
    const int64_t rr = row / k_pad;
    const float v = kk < k && j < d ? c[(rr * k + kk) * d + j] : 0.f;
    uint32_t h, l;
    split(v, h, l);
    hi[e] = __uint_as_float(h);
    lo[e] = __uint_as_float(l);
  }
}

// Row pitch of the X tile: 4 mod 8 floats, so a warp's fragment loads
// (8 rows x 4 columns) fall in 32 distinct banks.
__host__ __device__ inline int pitch_x(int d) { return pad_features(d) + 4; }

// The two shapes of a block.  kMT m16 tiles per warp, so 64 * kMT rows per
// block; kSplitX: X is split into hi and lo planes once, as the tile is
// loaded (narrow rows), or kept f32 and split as fragments are loaded (wide
// rows, where two planes would not fit).
template <int kMT, bool kSplitX>
struct Shape {
  static constexpr int kRowsT = 64 * kMT;
  static constexpr int kPlanes = kSplitX ? 2 : 1;
  // Shared floats: the C ring (2 stages x {hi, lo} x kCents x (dc + 4)),
  // the X planes (kRowsT x pitch_x each), |x|^2 and the merge of the two
  // centroid warps (values and indices, 2 x kRowsT each).
  __host__ __device__ static size_t smem_bytes(int d, int dc) {
    return sizeof(float) * ((size_t)4 * kCents * (dc + 4) +
                            (size_t)kPlanes * kRowsT * pitch_x(d) +
                            5 * kRowsT);
  }
  // Features per staged C chunk for width d: the widest multiple of 8 up
  // to the padded d (at most kMaxDepth) with which two blocks fit on an SM,
  // as long as it is 16 or the whole padded d; else the widest that fits
  // the `optin` bytes of one block; 0 when none does.
  __host__ static int stage_depth(int d, int optin) {
    const int dp = pad_features(d);
    const int top = dp < kMaxDepth ? dp : kMaxDepth;
    const int least[2] = {top < 16 ? top : 16, kStep};
    const size_t room[2] = {(size_t)kTwoPerSm, (size_t)optin};
    for (int p = 0; p < 2; ++p)
      for (int dc = top; dc >= least[p]; dc -= kStep)
        if (smem_bytes(d, dc) <= room[p]) return dc;
    return 0;
  }
};
using Narrow = Shape<2, true>;    // 128 rows, X split once: d <= 208
using Wide = Shape<1, false>;     // 64 rows, X f32: d <= 848

// Fewest 128-row tiles for which the narrow shape is used: two blocks on
// each of 132 SMs.  Below it, 64-row tiles keep more SMs busy (predict's
// 16384-row chunk: 256 blocks against 128).
constexpr int kNarrowTiles = 264;

// Widest d that one of the shapes takes in the shared memory a block may
// opt in to on `device` (848 on an H100); -1 when it cannot be queried.
__host__ inline int max_features(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int d = 0;
  while (Wide::smem_bytes(d + kStep, kStep) <= (size_t)optin) d += kStep;
  return d;
}

template <class S>
struct Tile {
  float* ring;      // 2 stages x {hi, lo} x kCents x (dc + 4)
  float* xs;        // S::kPlanes x kRowsT x pitch_x(d): f32, or hi then lo
  float* xsq;       // kRowsT
  float* red_v;     // 2 x kRowsT
  int* red_i;       // 2 x kRowsT
  __device__ Tile(float* base, int d, int dc) {
    ring = base;
    xs = ring + 4 * kCents * (dc + 4);
    xsq = xs + S::kPlanes * S::kRowsT * pitch_x(d);
    red_v = xsq + S::kRowsT;
    red_i = reinterpret_cast<int*>(red_v + 2 * S::kRowsT);
  }
};

// Rows [row0, row0 + rows) of X (row-major, d columns) into the tile, zero
// past d and past the rows; |x|^2 per row, columns in increasing order;
// then, for a split shape, the hi and lo planes.
template <class S>
__device__ void load_rows(const Tile<S>& sm, const float* __restrict__ x,
                          int64_t row0, int rows, int d) {
  const int dp = pad_features(d), px = pitch_x(d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < S::kRowsT; i += kThreads / 32)
    for (int j = lane; j < dp; j += 32)
      sm.xs[i * px + j] = i < rows && j < d ? x[(row0 + i) * d + j] : 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < S::kRowsT; i += kThreads) {
    const float* row = sm.xs + i * px;
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
    sm.xsq[i] = s;
  }
  if (S::kPlanes == 2) {
    __syncthreads();              // every row's |x|^2 is read

    float* lo = sm.xs + S::kRowsT * px;
    for (int i = warp; i < S::kRowsT; i += kThreads / 32)
      for (int j = lane; j < dp; j += 32) {
        uint32_t h, l;
        split(sm.xs[i * px + j], h, l);
        sm.xs[i * px + j] = __uint_as_float(h);
        lo[i * px + j] = __uint_as_float(l);
      }
  }
  __syncthreads();
}

// Nearest centroid of each row of the tile against the k centroids of one
// problem: chi / clo its split halves (pad_centroids(k) x pad_features(d))
// and csq its norms.  Leaves each row's (min, argmin) in red_v[0..kRowsT)
// / red_i[0..kRowsT) and ends with __syncthreads().  Rows past the data
// are computed on zeros; the caller ignores them.
template <class S>
__device__ void sweep(const Tile<S>& sm, const float* __restrict__ chi,
                      const float* __restrict__ clo,
                      const float* __restrict__ csq, int k, int d, int dc) {
  constexpr int MT = S::kRowsT / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp & 3, wn = warp >> 2;  // 16*MT-row and 32-centroid slices
  const int g = lane >> 2, t = lane & 3;    // fragment row / column
  const int dp = pad_features(d), px = pitch_x(d), pc = dc + 4;
  const int n_ds = cdiv(dp, dc), n_stages = cdiv(k, kCents) * n_ds;
  const int stage_floats = 2 * kCents * pc;

  // Copies of stage s (centroid chunk s / n_ds, features (s % n_ds) * dc
  // on) into ring slot s & 1: the 16-byte vectors of 64 hi rows, then of
  // 64 lo rows, spread over all lanes.
  auto load_stage = [&](int s) {
    const int kc = s / n_ds, d0 = (s - kc * n_ds) * dc;
    const int vec = min(dc, dp - d0) / 4;
    float* dst = sm.ring + (s & 1) * stage_floats;
    const int64_t first = (int64_t)kc * kCents * dp + d0;
    for (int e = threadIdx.x; e < 2 * kCents * vec; e += kThreads) {
      const int row = e / vec, v4 = e - row * vec;
      cp_async16(dst + row * pc + v4 * 4,
                 (row < kCents ? chi : clo) + first +
                     (int64_t)(row % kCents) * dp + v4 * 4);
    }
    cp_async_commit();
  };

  float best[MT][2];
  int arg[MT][2];
  float xn[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[m][h] = INFINITY;
      arg[m][h] = 0x7fffffff;
      xn[m][h] = sm.xsq[wm * 16 * MT + m * 16 + g + 8 * h];
    }
  float big[MT][4][4], small[MT][4][4];
  // fragment (m, q) of A: row wm*16*MT + m*16 + g + 8 (q & 1), column
  // t + 4 (q >> 1) of the k step
  const float* xa = sm.xs + (wm * 16 * MT + g) * px + t;
  const float* xl = xa + S::kRowsT * px;    // the lo plane, when split

  load_stage(0);
  for (int s = 0; s < n_stages; ++s) {
    const int kc = s / n_ds, ds = s - kc * n_ds, d0 = ds * dc;
    if (ds == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) big[m][j][q] = small[m][j][q] = 0.f;
    }
    if (s + 1 < n_stages) {
      load_stage(s + 1);              // slot (s + 1) & 1 was consumed at s - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ch = sm.ring + (s & 1) * stage_floats + (wn * 32 + g) * pc + t;
    const float* cl = ch + kCents * pc;
    const int depth = min(dc, dp - d0);
    for (int kk = 0; kk < depth; kk += kStep) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = (m * 16 + 8 * (q & 1)) * px + d0 + kk + 4 * (q >> 1);
          if (S::kPlanes == 2) {
            ah[m][q] = __float_as_uint(xa[o]);
            al[m][q] = __float_as_uint(xl[o]);
          } else {
            split(xa[o], ah[m][q], al[m][q]);
          }
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = j * 8 * pc + kk;
        const uint32_t bh0 = __float_as_uint(ch[o]), bh1 = __float_as_uint(ch[o + 4]);
        const uint32_t bl0 = __float_as_uint(cl[o]), bl1 = __float_as_uint(cl[o + 4]);
        // x_hi.c_hi of this k step from zero, added into `big` with
        // round-to-nearest f32 adds: the MMA's own accumulation truncates,
        // which over a whole d would bias the large product
        float step[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int q = 0; q < 4; ++q) step[m][q] = 0.f;
          mma_tf32(step[m], ah[m], bh0, bh1);
          mma_tf32(small[m][j], ah[m], bl0, bl1);
          mma_tf32(small[m][j], al[m], bh0, bh1);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) big[m][j][q] += step[m][q];
      }
    }
    __syncthreads();              // slot s & 1 is consumed
    if (ds != n_ds - 1) continue;
    // The chunk's distances: accumulator q of (m, n-tile j) is row
    // wm*16*MT + m*16 + g + 8 (q / 2), centroid kc*64 + wn*32 + j*8 + 2t +
    // (q % 2).
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = kc * kCents + wn * 32 + j * 8 + 2 * t + (q & 1);
        if (col < k) {            // the ragged K edge never competes
          const float cn = csq[col];
          const int h = q >> 1;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            float v = __fadd_rn(xn[m][h] - 2.f * (big[m][j][q] + small[m][j][q]), cn);
            v = v < 0.f ? 0.f : v;  // clamp; NaN stays NaN
            // a thread meets its columns in increasing order, so
            // before(v, col, best, arg) is: smaller, or the first NaN
            if (v < best[m][h] || (isnan(v) && !isnan(best[m][h]))) {
              best[m][h] = v;
              arg[m][h] = col;
            }
          }
        }
      }
  }
  // Merge the four lanes of a row, then the two centroid warps.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[m][h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[m][h], off);
        if (before(ob, oa, best[m][h], arg[m][h])) {
          best[m][h] = ob;
          arg[m][h] = oa;
        }
      }
      if (t == 0) {
        const int row = wn * S::kRowsT + wm * 16 * MT + m * 16 + g + 8 * h;
        sm.red_v[row] = best[m][h];
        sm.red_i[row] = arg[m][h];
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < S::kRowsT; i += kThreads) {
    const float ob = sm.red_v[S::kRowsT + i];
    const int oa = sm.red_i[S::kRowsT + i];
    if (before(ob, oa, sm.red_v[i], sm.red_i[i])) {
      sm.red_v[i] = ob;
      sm.red_i[i] = oa;
    }
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace repro

namespace repro {

template <class S>
__global__ void __launch_bounds__(tc::kThreads, 2)
assign_tc(const float* __restrict__ x, const float* __restrict__ chi,
          const float* __restrict__ clo, const float* __restrict__ csq,
          int n, int k, int d, int dc, int* __restrict__ labels,
          float* __restrict__ mind) {
  extern __shared__ float4 smem_raw[];
  const tc::Tile<S> sm(reinterpret_cast<float*>(smem_raw), d, dc);
  const int64_t row0 = (int64_t)blockIdx.x * S::kRowsT;
  const int rows = n - row0 < S::kRowsT ? (int)(n - row0) : S::kRowsT;
  tc::load_rows(sm, x, row0, rows, d);
  tc::sweep(sm, chi, clo, csq, k, d, dc);
  for (int i = threadIdx.x; i < rows; i += tc::kThreads) {
    labels[row0 + i] = sm.red_i[i];
    mind[row0 + i] = sm.red_v[i];
  }
}

template <class S>
cudaError_t launch_assign(cudaStream_t s, const float* x, const float* chi,
                          const float* clo, const float* csq, int n, int k,
                          int d, int dc, int* labels, float* mind) {
  const size_t smem = S::smem_bytes(d, dc);
  cudaError_t err = set_smem(assign_tc<S>, smem);
  if (err != cudaSuccess) return err;
  assign_tc<S><<<cdiv(n, S::kRowsT), tc::kThreads, smem, s>>>(
      x, chi, clo, csq, n, k, d, dc, labels, mind);
  return cudaGetLastError();
}

}  // namespace repro

using namespace repro;

// Floats of scratch: the split halves of C, then |c|^2.
extern "C" long long probe_scratch_floats(int k, int d) {
  return 2LL * tc::pad_centroids(k) * tc::pad_features(d) + k;
}

// One problem: X (n, d), C (k, d), all float32 on the device.
extern "C" int probe_launch(const void* x, const void* c, int n, int k, int d,
                            void* scratch, void* labels, void* mind,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const bool many = cdiv(n, tc::Narrow::kRowsT) >= tc::kNarrowTiles;
  const int dc_narrow = many ? tc::Narrow::stage_depth(d, optin) : 0;
  const int dc_wide = tc::Wide::stage_depth(d, optin);
  if (dc_narrow == 0 && dc_wide == 0) return (int)cudaErrorInvalidValue;
  const int k_pad = tc::pad_centroids(k), d_pad = tc::pad_features(d);
  const int64_t half = (int64_t)k_pad * d_pad;
  float* chi = static_cast<float*>(scratch);
  float* clo = chi + half;
  float* csq = clo + half;
  const float* cf = static_cast<const float*>(c);
  row_sqnorms<<<(unsigned)((k + 7) / 8), kThreads, 0, s>>>(cf, k, d, csq);
  tc::split_tf32<<<(unsigned)((half + 255) / 256 < 4096 ? (half + 255) / 256 : 4096),
                   256, 0, s>>>(cf, 1, k, d, k_pad, d_pad, chi, clo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  int* lab = static_cast<int*>(labels);
  float* md = static_cast<float*>(mind);
  return (int)(dc_narrow
                   ? launch_assign<tc::Narrow>(s, xf, chi, clo, csq, n, k, d,
                                               dc_narrow, lab, md)
                   : launch_assign<tc::Wide>(s, xf, chi, clo, csq, n, k, d,
                                             dc_wide, lab, md));
}
