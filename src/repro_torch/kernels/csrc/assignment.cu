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
// are ~100x less (at 128,256 x 4096, K = 256: 4.02 ms of operations
// against 0.63 ms of X).  Up to the widest resident tile (821 features on
// an H100) the cross terms run in sweep_fp32.cuh's 8 x 8 register blocks
// with X held in shared memory and C transposed once per launch and
// streamed through a cp.async ring.  Past it X streams through
// sweep_wide.cuh's kernel, an FP32 GEMM with the argmin as its epilogue:
// 128-row x 256-slot blocks of 256 threads, one an SM, each lane holding
// 8 x 16 cross terms (190-219 registers, no spill); 32-feature stages in a
// three-slot ring, one barrier a stage, each stage's C box (and X box,
// where rows start 16-byte aligned) copied by TMA onto an mbarrier, X
// moved from that raw slab into a transposed one in 4 x 4 blocks (other
// rows: plain loads a stage ahead); no running minimum in registers
// across the FMA loop.  It replaced a streamed 8 x 8 sweep (492 bytes of
// spills, 1.36x addmm + argmin; sweep_wide.cuh says where that one lost
// time).
// Each block owns its rows and all K centroids, so nothing is reduced
// across blocks: a relaunch is bitwise equal.  The fused step launches the
// same sweep (f8::launch_assign), and the bounded step's computes each
// distance with the same FMA chain, so their distances are these bit for
// bit.

#include "sweep_wide.cuh"

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
