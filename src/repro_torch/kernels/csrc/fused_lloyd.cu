// One Lloyd step, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_lloyd.py::_fused_kernel
// (pl.pallas_call at :333, wrapper fused_lloyd_pallas at :367).  For every
// row: its nearest centroid (label, unweighted squared distance); for every
// cluster: the weighted sum of its rows and their total weight; per
// problem: the energy sum(w * min distance).  Shapes: X (N, d) shared by R
// centroid sets or (R, N, d) one per set; C (R, K, d); weights none, (N,)
// or (R, N).  X and C are each float32 or bfloat16 (the TPU kernel's bf16
// compute policy: X and C in bf16, |x|^2, |c|^2, the cross terms and the
// stats accumulated in f32); weights and every output are float32.
//
// What bounds it on this card: the cross terms, 2*N*K*d operations: on
// bf16 X and C the tensor cores' bf16 products (989 TFLOP/s, 0.34 ms at
// USCensus1990, K = 1000) beside the epilogue on the CUDA cores; on f32 or
// mixed operands the FP32 cores (67 TFLOP/s, 5.18 ms there), against N*d
// bytes of X read once (3.35 TB/s).  The design is two passes over X, not
// the TPU kernel's one:
//   1. the assignment kernel's own launch (sweep_wide.cuh's launch_assign)
//      writes each row's label and distance, so the step's labels and
//      distances are the assignment's by construction: on bf16 X and C
//      the tensor-core sweep of sweep_tc.cuh at any d (wgmma on 128-row
//      tiles, C packed in bf16 and brought by TMA); otherwise, up to 821
//      features on an H100, sweep_fp32.cuh's 8 x 8 register blocks with
//      the X tile resident in shared memory and C streamed by cp.async,
//      and past that sweep_wide.cuh's streamed kernel (128-row x 256-slot
//      blocks, 8 x 16 cross terms a lane, 32-feature stages of C and X
//      copied by TMA into a three-slot ring, X by plain loads where its
//      rows are not 16-byte aligned), so any d runs (PERF.md has their
//      times);
//   2. the update kernel's segment sum adds the stats of those labels,
//      reading X a second time: segment_sum.cuh's on a float32 X,
//      segment_sum_bf16.cuh's on a bfloat16 one (which equals the first
//      on the upcast X bit for bit);
//   3. the energy sum(w * min distance) is summed over the rows in two
//      stages (stats.cuh): in the sweep it cost registers the sweep spilled.
// A one-pass kernel must keep each block's (K, d+1) partial stats in
// device memory (280 KB at K = 1000: more than a block's shared memory);
// on the H100 its gather cost 1.85 ms a step beside the sweep, against the
// segment sum's 0.65 ms, X's second read included (PERF.md).
//
// Determinism: no atomics.  The segment sum's partials are summed in slab
// order, the energy by fixed row ranges and trees (stats.cuh).  Same
// inputs, same launch config -> bitwise the same outputs.

#include "segment_sum_bf16.cuh"
#include "sweep_wide.cuh"

using namespace repro;

// Floats of scratch one launch needs: the sweep's (C transposed or packed,
// |c|^2), then the energy's partials.
extern "C" long long fused_lloyd_scratch_floats(int r, int k, int d) {
  return f8::assign_scratch_floats(r, k, d) + (long long)r * kEnergyBlocks;
}

// Launches one step on `stream`: |c|^2 and C's transpose or packing, the
// sweep, the segment sum with the layout `lay` (tiles.update_layout, or
// tiles.update_bf16_layout on a bf16 X: groups, width, warps, ranges,
// range_k, slabs, tiles_per_slab, smem, stages) and the energy.
// Pointers are device pointers; x_type / c_type are X's and C's type codes
// (nearest.cuh: 0 float32, 1 bfloat16); w may be null (every weight 1).
// x_rstride / w_rstride are the element offsets between problems (0 when
// shared).  force_stream != 0 streams X through the FP32 sweep at any d
// (refused where X and C are both bf16: launch_assign).
// scratch (fused_lloyd_scratch_floats(r, k, d) floats, 16-byte aligned)
// and part (R * slabs * K * (d+1)) are scratch.  Returns the first CUDA
// error (0 on success); nothing synchronises.
extern "C" int fused_lloyd_launch(
    const void* x, int x_type, long long x_rstride, const void* c,
    int c_type, const void* w, long long w_rstride, int r, int n, int k,
    int d, int force_stream, const int* lay, void* scratch, void* labels,
    void* mind, void* part, void* sums, void* counts, void* energy,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const UpdateLayout ul{lay[0], lay[1], lay[2], lay[3], lay[4],
                        lay[5], lay[6], lay[7], lay[8]};
  return (int)with_operand_types(x, x_type, c, c_type, [&](auto xt, auto ct) {
    float* const part_e =
        static_cast<float*>(scratch) + f8::assign_scratch_floats(r, k, d);
    cudaError_t err = f8::launch_assign(
        s, xt, x_rstride, ct, r, n, k, d, force_stream != 0,
        static_cast<float*>(scratch),
        static_cast<int*>(labels), static_cast<float*>(mind));
    if (err != cudaSuccess) return err;
    err = launch_stats(s, xt, x_rstride,
                             static_cast<const int*>(labels), wf, w_rstride,
                             r, n, k, d, ul, static_cast<float*>(part),
                             static_cast<float*>(sums),
                             static_cast<float*>(counts));
    if (err != cudaSuccess) return err;
    return launch_energy(s, r, static_cast<const float*>(mind), wf,
                         w_rstride, n, part_e, nullptr, 0,
                         static_cast<float*>(energy), nullptr);
  });
}

// Widest d of the FP32 sweep's resident path; wider rows stream.
extern "C" int fused_lloyd_max_features(int device) {
  return f8::max_features(device);
}

// Rows per tile of the sweep.
extern "C" int fused_lloyd_tile_rows() { return f8::kRows; }

extern "C" const char* fused_lloyd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
