// Nearest-centroid assignment for Hopper (sm_90a): labels and squared
// distances, no cluster stats.
//
// Replaces the TPU kernel src/repro/kernels/assignment.py::_assignment_kernel
// (pl.pallas_call at :98, wrapper assignment_pallas at :120).  Shapes: X
// (N, d) shared by R centroid sets or (R, N, d); C (R, K, d); X and C each
// float32 or bfloat16 -> labels int32 (R, N), min squared distance float32
// (R, N).
//
// Two sweeps, picked by the operand types (f8::launch_assign):
//  - X and C both bfloat16, the reference's bf16 compute policy: the
//    tensor-core sweep of sweep_tc.cuh (wgmma m64n128k16 on bf16 operands
//    with f32 accumulation, C packed once per launch and brought by TMA,
//    the argmin as the epilogue), at any d.  Bound: the bf16 products at
//    989 TFLOP/s beside the epilogue's instructions on the CUDA cores
//    (0.34 ms of products at 2,458,285 x 69, K = 1000).  Its distances
//    differ from the FP32 sweeps' in the order of the f32 sums only.
//  - float32, or one operand of each type (converted to f32 as it is
//    loaded, so mixed types compute in f32 as JAX's promotion does): the
//    FP32 sweeps, bounded by 2*N*K*d FMA operations at 67 TFLOP/s on the
//    CUDA cores; the bytes (N*d*4 in, N*8 out) are ~100x less (at 128,256
//    x 4096, K = 256: 4.02 ms of operations against 0.63 ms of X).  Up to
//    the widest resident tile (821 features on an H100) the cross terms
//    run in sweep_fp32.cuh's 8 x 8 register blocks with X held in shared
//    memory and C transposed once per launch and streamed through a
//    cp.async ring.  Past it X streams through sweep_wide.cuh's kernel,
//    an FP32 GEMM with the argmin as its epilogue: 128-row x 256-slot
//    blocks of 256 threads, one an SM, each lane holding 8 x 16 cross
//    terms; 32-feature stages in a three-slot ring whose C box (and X
//    box, where rows start 16-byte aligned) comes by TMA onto an mbarrier
//    (sweep_wide.cuh says where the streamed 8 x 8 sweep it replaced lost
//    time).
// Each block owns its rows and all K centroids, so nothing is reduced
// across blocks: a relaunch is bitwise equal.  The fused step launches the
// same sweep (f8::launch_assign), so its labels and distances are these
// bit for bit; the bounded step computes each distance with the FP32
// sweeps' FMA chain.

#include "sweep_wide.cuh"

using namespace repro;

// Floats of scratch one launch needs: C transposed (or packed in bf16),
// then |c|^2.
extern "C" long long assignment_scratch_floats(int r, int k, int d) {
  return f8::assign_scratch_floats(r, k, d);
}

// Launches |c|^2, C's transpose or packing and the assignment on
// `stream`; x_type / c_type are X's and C's type codes (nearest.cuh: 0
// float32, 1 bfloat16); scratch holds assignment_scratch_floats(r, k, d)
// floats (16-byte aligned, as torch allocates); force_stream != 0 streams
// X through the FP32 sweep at any d (the resident and streamed launches
// are equal bit for bit where both fit; refused where both operands are
// bf16).  Returns the first CUDA error (0 on success).
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

// The tensor-core sweep's cross terms x.c (f32, before the epilogue)
// into out (R, n, k), for bf16 X and C as assignment_launch takes them: a
// measurement of its accumulation, which no path launches.  scratch as
// for assignment_launch.
extern "C" int assignment_cross_launch(const void* x, long long x_rstride,
                                       const void* c, int r, int n, int k,
                                       int d, void* scratch, void* out,
                                       void* stream) {
  return (int)tc::launch(static_cast<cudaStream_t>(stream),
                         static_cast<const __nv_bfloat16*>(x), x_rstride,
                         static_cast<const __nv_bfloat16*>(c), r, n, k, d,
                         static_cast<float*>(scratch), nullptr, nullptr,
                         static_cast<float*>(out));
}

// Widest d of the FP32 sweep's resident path; wider rows stream.
extern "C" int assignment_max_features(int device) {
  return f8::max_features(device);
}

extern "C" const char* assignment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
