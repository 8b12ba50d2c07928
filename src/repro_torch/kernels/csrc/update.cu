// Weighted segment sum for Hopper (sm_90a): the Update half of a Lloyd
// step for a known assignment.
//
// Replaces the TPU kernel src/repro/kernels/update.py::_update_kernel
// (pl.pallas_call at :80, wrapper update_pallas at :102).  For R label
// sets: sums[r, k] = sum of w_i * x_i over the rows labelled k, and
// counts[r, k] = sum of their w_i.  A label outside [0, K) adds nothing
// (the TPU wrapper gives its padding rows label -1).  Shapes: X (N, d)
// shared by the R label sets or (R, N, d) one per set; labels (R, N)
// int32; weights none or (N,) float32; X float32 or bfloat16 -> sums
// (R, K, d), counts (R, K) float32.  A bfloat16 X takes its own kernel,
// segment_sum_bf16.cuh's (its layout tiles.update_bf16_layout), which
// sums every cell in this kernel's order, so it equals the float32 launch
// on the upcast X bit for bit.
//
// What bounds it on this card: bytes.  X, the labels and the weights are
// read once, (N*d + 2N)*4 bytes: 0.7 GB, 0.21 ms at 3.35 TB/s at N = 2.46 M,
// d = 69; the work is one multiply-add per element.  (The TPU computes a
// one-hot matmul on the MXU, 2*N*K*d operations that the MXU hides; on
// this card that would be K times the work.)  The design keeps every
// thread busy, every read-modify-write in shared memory and enough bytes
// in flight to stream X:
//   * block (slab, range, group, r) owns a fixed contiguous slab of row
//     tiles, a range of clusters and a group of the d+1 output columns
//     (column d is the weight total); its (clusters, columns) f32 partial
//     lives in shared memory.  One block of up to 16 warps runs on each SM,
//     so the partial can be wide (two groups of 35 columns at K = 1000,
//     each reading its own columns of X) and cluster ranges are needed
//     only where K is too large for a group of one column per warp
//     (tiles.update_layout);
//   * a three-slot cp.async ring stages 128-row tiles of the group's
//     columns, with their labels and weights: while a tile is added, the
//     next has landed and the one after is in flight.  128 rows, not 64,
//     halve how often a block pays its fixed cost per tile (a barrier and
//     the peers' search).  A row of d = 69 floats is 276 bytes, not
//     16-byte aligned, so each row's columns are copied as the 16-byte
//     vectors that cover them (zero-filled past the end of X) and read at
//     their offset in the first vector: a quarter of the copy
//     instructions that 4-byte copies take;
//   * each warp owns a fixed subset of the group's columns; its lanes take
//     32 consecutive rows.  __match_any_sync on the labels, once per
//     32-row group and tile (by the last warps, a tile ahead), gives each
//     lane its peers; the lowest peer sums the peers' values in lane order and
//     alone adds the result into partial[label][column].  No two warps
//     write one cell and row groups go in order, so the order of every
//     addition depends on the data alone: no atomics, and a relaunch is
//     bitwise equal;
//   * each block writes its partial once to (R, slabs, K, d+1) in device
//     memory, sized to stay inside the L2, and `reduce_slabs` (stats.cuh)
//     sums the slabs in slab order.
// The kernel is in segment_sum.cuh, which the fused kernels share: they
// add the stats of the labels their sweep has just written with it.  On a
// bfloat16 X all three launch segment_sum_bf16.cuh's kernel instead
// (launch_stats picks), which reads X at 2 bytes and sums long runs of
// one label by columns.

#include "segment_sum_bf16.cuh"

// Launches the two kernels on `stream` with the layout of
// tiles.update_layout (float32 X) or tiles.update_bf16_layout (bfloat16 X;
// `stages` its ring slots, unread for float32).  Pointers are device pointers; x_type is X's type
// code (nearest.cuh: 0 float32, 1 bfloat16); w may be null (every weight
// 1).  x_rstride is the element offset between problems (0 when X is
// shared).  part (R*slabs*K*(d+1) floats) is scratch.  Returns the first
// CUDA error (0 on success); nothing synchronises.
extern "C" int update_launch(const void* x, int x_type, long long x_rstride,
                             const void* labels, const void* w, int r, int n,
                             int k, int d, int groups, int width, int warps,
                             int ranges, int range_k, int slabs,
                             int tiles_per_slab, int smem, int stages,
                             void* part, void* sums, void* counts,
                             void* stream) {
  const UpdateLayout lay{groups, width,          warps, ranges, range_k,
                         slabs,  tiles_per_slab, smem,  stages};
  return (int)with_operand_types(x, x_type, nullptr, 0, [&](auto xt, auto) {
    return launch_stats(
        static_cast<cudaStream_t>(stream), xt, x_rstride,
        static_cast<const int*>(labels), static_cast<const float*>(w), 0, r,
        n, k, d, lay, static_cast<float*>(part), static_cast<float*>(sums),
        static_cast<float*>(counts));
  });
}

extern "C" const char* update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
