// One Lloyd step that skips centroid groups no row of a tile can need, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_lloyd.py::
// _fused_bounds_kernel (pl.pallas_call at :262, launcher
// _fused_bounds_call at :224).  The fused step (fused_lloyd.cu) plus the
// bound contract of core/backends/bounds.py, in squared space: for every
// row its previous label lab0, a squared upper bound ub^2 on the distance
// to that centroid, and squared lower bounds lb^2 (N, G) on the distance
// to every centroid of each group of gs contiguous centroids.  Group g of
// a 64-row tile (f8::kRows) is computed when any row of the tile that
// holds data has lb^2[row, g] <= ub^2[row]; otherwise the whole block
// skips the group's C loads and FMAs, and the group's lb^2 passes through
// as its new minimum.  The running min starts at (ub^2, lab0) and the seed wins a
// tie (nearest.cuh), so a row whose other groups are all skipped still
// ends at its exact label.  Outputs: the fused step's five, the squared
// group minima gmin^2 (R, N, G) (a computed group's minimum over its own
// centroids; a skipped group's lb^2, bit for bit) and the count of skipped
// (tile, group) cells per problem (R,), summed as integers.  X and C are
// each float32 or bfloat16; the bounds, weights and outputs are float32.
// Where X and C are both bf16 and gs is a multiple of 8, the sweep is the
// tensor-core one (sweep_tc.cuh, bounds_tc), as the fused step's is on such
// operands; otherwise X and C are converted to f32 as they are loaded (the
// FP32 sweeps' rule), so a mixed launch equals the f32 launch on the
// upcast operands.
//
// What bounds it on this card: the cross terms of the computed groups,
// (1 - skip) * 2*N*K*d FP32 operations (67 TFLOP/s), or bf16 products on
// the tensor cores (989 TFLOP/s) beside the epilogue's instructions on the
// CUDA cores (take()'s 7 and the group minimum's 1 a (row, centroid)),
// against X, the bounds and the group minima read or written once,
// (N*d*b + 2*N*G*4 + 4*N*4) bytes with b = 4 or 2 (3.35 TB/s).  The FP32
// design is the fused step's (fused_lloyd.cu: the
// sweep, then the segment sum over the labels: segment_sum.cuh's, or
// segment_sum_bf16.cuh's on a bf16 X) with the
// C stages filled from the computed groups only: the 16-byte vectors of C
// that hold a centroid of a computed group are listed a chunk of 64 ahead
// of the sweep, and the sweep copies and multiplies those, so its work
// follows the computed share at any group size and its shared memory does
// not grow with K; a block that computes every group lists nothing and
// sweeps C in order.  A vector's centroids of skipped groups are padding
// and never compete.  Three sweeps:
//  - up to the widest resident d (a little under 821 features on an H100,
//    less as G grows) this file's bounds_tiles: one 64-row tile a block,
//    the whole X tile resident in shared memory, the 8 x 8 sweep of
//    sweep_fp32.cuh (half the FMAs where the live vectors fill half of one
//    chunk); each computed group's minimum is merged across the warp at
//    the end of each chunk it meets (a group that goes on keeps its
//    minimum so far in shared memory, not in registers);
//  - past it, or where the launcher forces it, sweep_bounded.cuh's
//    streamed sweep (sweep_wide.cuh's design: 128-row blocks of two tiles,
//    8 x 16 cross terms a lane, 32-feature stages of X and C in a TMA
//    ring), so any d runs;
//  - bf16 X and C with gs a multiple of 8, at every d: sweep_tc.cuh's
//    bounds_tc (wgmma in 128-row blocks, each warpgroup one 64-row tile;
//    chunks of 128 slots listed where a tile computes a group; the group
//    minima in registers, the seed merged last).  Its cross terms sum in
//    another order, so its bits are not the f32 launch's: labels equal the
//    plain version's but at near ties, distances and computed group minima
//    within 1e-5 of |x|^2 + max |c|^2, skipped minima and the skipped share
//    exact; at ub^2 = +inf, lb^2 = 0 it equals the bf16 fused step.
// The two FP32 sweeps give the same bits wherever both fit.  No atomics
// but the need bits' atomicOr, whose result does not depend on the order.

#include <type_traits>

#include "segment_sum_bf16.cuh"
#include "sweep_bounded.cuh"
#include "sweep_fp32.cuh"

namespace repro {

// Shared words beyond the sweep's: the open group minima (kRows), the
// lists of live vectors (f8::kListWords) and the need bits.
__host__ __device__ inline size_t bounds_extra(int g) {
  return f8::kRows + f8::kListWords + need_words(g);
}

constexpr int kLbRegs = 4;   // bounds a thread holds: 64 rows x 16 groups
static_assert(tc::kTileRows == f8::kRows,
              "the tensor-core sweep's skip tile is the FP32 sweeps'");

// The resident path: one 64-row tile a block, the whole X tile in shared
// memory.  kVecGroups: gs and K multiples of 4, so that each 4-centroid
// vector lies in one group and below K (sweep_fp32.cuh then merges a chunk
// that lies in one group without masks).  TX: X's element type.
template <bool kVecGroups, typename TX>
__global__ void __launch_bounds__(f8::kThreads, 2)
bounds_tiles(const TX* __restrict__ x, int64_t x_rstride,
             const float* __restrict__ ct, const float* __restrict__ csq,
             const int* __restrict__ lab0, const float* __restrict__ lb,
             const float* __restrict__ ub, int n, int k, int d, int dc,
             int gs, int g, int* __restrict__ labels,
             float* __restrict__ mind, float* __restrict__ gmin,
             int* __restrict__ part_skip) {
  extern __shared__ float4 smem_raw[];
  const f8::Tile sm(reinterpret_cast<float*>(smem_raw), d, dc, true);
  unsigned* open = reinterpret_cast<unsigned*>(sm.extra);  // kRows
  int* live = reinterpret_cast<int*>(open + f8::kRows);    // 2 x kVecs
  int* scan = live + 2 * f8::kVecs;                        // kWarps + 1
  unsigned* need = reinterpret_cast<unsigned*>(scan + f8::kWarps + 1);
  const int r = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * f8::kRows;
  const int rows = n - row0 < f8::kRows ? (int)(n - row0) : f8::kRows;
  const int64_t at = (int64_t)r * n + row0;           // the tile's first row
  // The tile's bounds, the first kLbRegs * 256 of its rows x G in
  // registers.  The skip test and the live vectors come first, so that the
  // first stage of C is in flight while X is stored.
  const float* lbt = lb + at * g;
  const int cells = rows * g;
  float lbv[kLbRegs];
#pragma unroll
  for (int t = 0; t < kLbRegs; ++t) {
    const int e = t * f8::kThreads + threadIdx.x;
    lbv[t] = e < cells ? lbt[e] : 0.f;
  }
  if (threadIdx.x < f8::kRows) {
    const bool real = threadIdx.x < rows;
    sm.mind[threadIdx.x] = real ? ub[at + threadIdx.x] : 0.f;
    sm.lab[threadIdx.x] = real ? lab0[at + threadIdx.x] : 0;
  }
  for (int e = threadIdx.x; e < need_words(g); e += f8::kThreads) need[e] = 0u;
  if (threadIdx.x == 0) scan[f8::kWarps] = 0;   // the list's cursor
  __syncthreads();

  // The skip test of every (tile, group) cell over the tile's real rows.
  // With G <= 32 every lane's bit is in word 0: a warp ORs its lanes' bits
  // first, and one lane sets them.
  // cell e = t * 256 + thread is row e / g, group e % g: stepped, not
  // divided, from one t to the next
  const int q_step = f8::kThreads / g, r_step = f8::kThreads % g;
  auto next_cell = [&](int& row, int& grp) {
    row += q_step;
    grp += r_step;
    if (grp >= g) {
      grp -= g;
      ++row;
    }
  };
  int row_t = threadIdx.x / g, grp_t = threadIdx.x % g;
  auto test = [&](int e, float bound) {
    const int grp = grp_t;
    const bool hit = e < cells && bound <= sm.mind[row_t];
    next_cell(row_t, grp_t);
    if (g <= 32) {
      const unsigned bits =
          __reduce_or_sync(0xffffffffu, hit ? 1u << grp : 0u);
      if (threadIdx.x % 32 == 0 && bits) atomicOr(need, bits);
    } else if (hit) {
      atomicOr(&need[grp >> 5], 1u << (grp & 31));
    }
  };
#pragma unroll
  for (int t = 0; t < kLbRegs; ++t) {
    if (t * f8::kThreads >= cells) break;
    test(t * f8::kThreads + threadIdx.x, lbv[t]);
  }
  for (int e0 = kLbRegs * f8::kThreads; e0 < cells; e0 += f8::kThreads) {
    const int e = e0 + threadIdx.x;
    test(e, e < cells ? lbt[e] : 0.f);
  }
  __syncthreads();
  int on = 0;                             // computed groups
  for (int q = 0; q < need_words(g); ++q) on += __popc(need[q]);
  if (threadIdx.x == 0) part_skip[(int64_t)r * gridDim.x + blockIdx.x] = g - on;
  // A skipped group's bound passes through as its minimum.
  float* gmint = gmin + at * g;
  row_t = threadIdx.x / g;
  grp_t = threadIdx.x % g;
  auto pass = [&](int e, float bound) {
    const int grp = grp_t;
    next_cell(row_t, grp_t);
    if (e < cells && !((need[grp >> 5] >> (grp & 31)) & 1u)) gmint[e] = bound;
  };
#pragma unroll
  for (int t = 0; t < kLbRegs; ++t) {
    if (t * f8::kThreads >= cells) break;
    pass(t * f8::kThreads + threadIdx.x, lbv[t]);
  }
  for (int e0 = kLbRegs * f8::kThreads; e0 < cells; e0 += f8::kThreads) {
    const int e = e0 + threadIdx.x;
    pass(e, e < cells ? lbt[e] : 0.f);
  }
  const f8::Skip skip{need, live, scan, on == g, k, gs, g, open, gmint, rows};
  const float* ctr = ct + (int64_t)r * d * f8::pad_centroids(k);
  const float* csqr = csq + (int64_t)r * k;
  // the live vectors of chunks 0 and 1 (the sweep lists the rest)
  const int n_first = skip.fill(0);
  if (n_first > 0) f8::start_stage<true>(sm, ctr, k, d, dc, 0, skip, n_first);
  const int n_second = n_first == f8::kVecs ? skip.fill(1) : 0;
  f8::load_rows(sm, x + r * x_rstride, row0, rows, d);
  if (n_first <= f8::kVecs / 2)   // one chunk, half full: half the FMAs
    f8::sweep<true, true, kVecGroups, true>(sm, ctr, csqr, k, d, dc, skip,
                                            n_first);
  else
    f8::sweep<true, true, kVecGroups>(sm, ctr, csqr, k, d, dc, skip,
                                      n_first, n_second);
  if (threadIdx.x < rows) {
    labels[at + threadIdx.x] = sm.lab[threadIdx.x];
    mind[at + threadIdx.x] = sm.mind[threadIdx.x];
  }
}

}  // namespace repro

using namespace repro;

// Floats of scratch one launch needs: C transposed (the FP32 sweeps) or
// packed (the tensor-core sweep), |c|^2, the energy's partials.
extern "C" long long fused_bounds_scratch_floats(int r, int k, int d) {
  return f8::assign_scratch_floats(r, k, d) + (long long)r * kEnergyBlocks;
}

// Launches one step on `stream`, as fused_lloyd_launch does with the
// bounded sweep (x_type / c_type: X's and C's type codes, nearest.cuh).
// lab0 (R, N) int32, lb (R, N, G) and ub (R, N) float32 are the squared
// bounds; gmin (R, N, G) and skipped (R,) int64 are outputs besides the
// fused step's.  part_skip (R * tiles int32) is scratch besides
// fused_lloyd_launch's; force_stream != 0 streams X through the FP32 sweep
// at any d (sweep_bounded.cuh; refused where X and C are both bf16 and gs
// is a multiple of 8, which take the tensor cores at every d).  Returns
// the first CUDA error (0 on success); nothing synchronises.
extern "C" int fused_bounds_launch(
    const void* x, int x_type, long long x_rstride, const void* c,
    int c_type, const void* w, long long w_rstride, const void* lab0,
    const void* lb, const void* ub, int r, int n, int k, int d, int gs,
    int g, int force_stream, const int* lay, void* scratch, void* labels,
    void* mind, void* gmin, void* part, void* part_skip, void* sums,
    void* counts, void* energy, void* skipped, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = cdiv(n, f8::kRows);
  const float* wf = static_cast<const float*>(w);
  const UpdateLayout ul{lay[0], lay[1], lay[2], lay[3], lay[4],
                        lay[5], lay[6], lay[7], lay[8]};
  return (int)with_operand_types(x, x_type, c, c_type, [&](auto xt, auto cp) {
    using TX = std::remove_cv_t<std::remove_pointer_t<decltype(xt)>>;
    using TC = std::remove_cv_t<std::remove_pointer_t<decltype(cp)>>;
    // the segment sum over the sweep's labels, then the energy and the
    // skipped cells (part_e: the energy's partials)
    auto stats = [&](float* part_e) {
      cudaError_t e = launch_stats(
          s, xt, x_rstride, static_cast<const int*>(labels), wf, w_rstride,
          r, n, k, d, ul, static_cast<float*>(part), static_cast<float*>(sums),
          static_cast<float*>(counts));
      if (e != cudaSuccess) return e;
      return launch_energy(s, r, static_cast<const float*>(mind), wf,
                           w_rstride, n, part_e,
                           static_cast<const int*>(part_skip), n_tiles,
                           static_cast<float*>(energy),
                           static_cast<long long*>(skipped));
    };
    cudaError_t err;
    if constexpr (std::is_same<TX, __nv_bfloat16>::value &&
                  std::is_same<TC, __nv_bfloat16>::value) {
      if (gs % 8 == 0) {
        // bf16 X and C: the tensor-core sweep at every d
        if (force_stream) return cudaErrorInvalidValue;
        const tc::Bounds bd{static_cast<const int*>(lab0),
                            static_cast<const float*>(lb),
                            static_cast<const float*>(ub), gs, g,
                            static_cast<float*>(gmin),
                            static_cast<int*>(part_skip)};
        float* const sc = static_cast<float*>(scratch);
        int* const lab = static_cast<int*>(labels);
        float* const md = static_cast<float*>(mind);
        err = tc::streams(d) ? tc::launch_bounds<true>(s, xt, x_rstride, cp,
                                                       r, n, k, d, sc, bd,
                                                       lab, md)
                             : tc::launch_bounds<false>(s, xt, x_rstride, cp,
                                                        r, n, k, d, sc, bd,
                                                        lab, md);
        if (err != cudaSuccess) return err;
        return stats(static_cast<float*>(scratch) +
                     f8::assign_scratch_floats(r, k, d));
      }
    }
    f8::SweepPlan plan;
    err = f8::plan_sweep(d, bounds_extra(g), true, force_stream != 0, &plan);
    if (err != cudaSuccess) return err;
    float *ct, *csq;
    err = f8::prepare_c(s, cp, r, k, d, static_cast<float*>(scratch), &ct,
                        &csq);
    if (err != cudaSuccess) return err;
    // REPRO_BOUNDS_GENERAL_MERGE (scripts/bounds_merge_probe.py builds a
    // copy with it) takes the general merge at every group size
#ifdef REPRO_BOUNDS_GENERAL_MERGE
    const bool vec_groups = false;
#else
    const bool vec_groups = gs % 4 == 0 && k % 4 == 0;
#endif
    const int* l0 = static_cast<const int*>(lab0);
    const float* lbf = static_cast<const float*>(lb);
    const float* ubf = static_cast<const float*>(ub);
    int* lab = static_cast<int*>(labels);
    float* md = static_cast<float*>(mind);
    float* gm = static_cast<float*>(gmin);
    int* ps = static_cast<int*>(part_skip);
    if (plan.stream) {
      err = vec_groups
                ? bwide::launch<true>(s, xt, x_rstride, ct, csq, l0, lbf, ubf,
                                      r, n, k, d, gs, g, lab, md, gm, ps)
                : bwide::launch<false>(s, xt, x_rstride, ct, csq, l0, lbf,
                                       ubf, r, n, k, d, gs, g, lab, md, gm,
                                       ps);
    } else {
      auto kernel =
          vec_groups ? bounds_tiles<true, TX> : bounds_tiles<false, TX>;
      err = set_smem(kernel, plan.smem);
      if (err != cudaSuccess) return err;
      kernel<<<dim3(n_tiles, r), f8::kThreads, plan.smem, s>>>(
          xt, x_rstride, ct, csq, l0, lbf, ubf, n, k, d, plan.dc, gs, g, lab,
          md, gm, ps);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return err;
    return stats(csq + (int64_t)r * k);
  });
}

// Widest d of the resident path: the widest whose tile, lists of live
// vectors and G need bits fit the shared memory a block may opt in to on
// `device`, for G groups (any K); -1 when the device cannot be queried.
// Wider rows stream.
extern "C" int fused_bounds_max_features(int device, int g) {
  return f8::max_features(device, bounds_extra(g), true);
}

// Rows per tile: the unit of the skip test.
extern "C" int fused_bounds_tile_rows() { return f8::kRows; }

extern "C" const char* fused_bounds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
