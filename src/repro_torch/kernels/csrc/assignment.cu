// Nearest-centroid assignment for Hopper (sm_90a): labels and squared
// distances, no cluster stats.
//
// Replaces the TPU kernel src/repro/kernels/assignment.py::_assignment_kernel
// (pl.pallas_call at :98, wrapper assignment_pallas at :120).  Shapes: X
// (N, d) shared by R centroid sets or (R, N, d); C (R, K, d); X and C each
// float32 or bfloat16 (converted to f32 as they are loaded, so mixed types
// compute in f32 as JAX's promotion does) -> labels int32 (R, N), min
// squared distance float32 (R, N).
//
// What bounds it on this card: operations, 2*N*K*d FMA operations at f32
// accuracy, 67 TFLOP/s on the CUDA cores; the bytes (N*d*4 in, N*8 out)
// are ~100x less.  The cross terms run on the CUDA cores in 8 x 8 register
// blocks (sweep_fp32.cuh): 64 FMAs per four shared loads, with C
// transposed once per launch and streamed through a cp.async ring, and X
// held in shared memory whole or, past the widest tile (821 features on an
// H100), streamed beside C in slabs of 32 features, so any d runs.  Each
// block owns one 64-row tile and all K centroids, so nothing is reduced
// across blocks: a relaunch is bitwise equal.  The fused step launches the
// same sweep (f8::launch_assign), and the bounded step's computes each
// distance with the same FMA chain, so their distances are these bit for
// bit.

#include "sweep_fp32.cuh"

using namespace repro;

// Floats of scratch one launch needs: C transposed, then |c|^2.
extern "C" long long assignment_scratch_floats(int r, int k, int d) {
  return f8::scratch_floats(r, k, d);
}

// Launches |c|^2, the transpose of C and the assignment on `stream`;
// x_type / c_type are X's and C's type codes (nearest.cuh: 0 float32, 1
// bfloat16); scratch holds assignment_scratch_floats(r, k, d) floats
// (16-byte aligned, as torch allocates); force_stream != 0 streams X at
// any d (the resident and streamed launches are equal bit for bit where
// both fit).  Returns the first CUDA error (0 on success).
extern "C" int assignment_launch(const void* x, int x_type,
                                 long long x_rstride, const void* c,
                                 int c_type, int r, int n, int k, int d,
                                 int force_stream, void* scratch,
                                 void* labels, void* mind, void* stream) {
  return (int)with_operand_types(x, x_type, c, c_type, [&](auto xt, auto ct) {
    return f8::launch_assign(static_cast<cudaStream_t>(stream), xt,
                             x_rstride, ct, r, n, k, d, force_stream != 0,
                             static_cast<float*>(scratch),
                             static_cast<int*>(labels),
                             static_cast<float*>(mind));
  });
}

// Widest d of the resident path; wider rows stream.
extern "C" int assignment_max_features(int device) {
  return f8::max_features(device);
}

extern "C" const char* assignment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
