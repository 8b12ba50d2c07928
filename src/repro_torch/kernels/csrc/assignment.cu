// Nearest-centroid assignment for Hopper (sm_90a): labels and squared
// distances, no cluster stats.
//
// Replaces the TPU kernel src/repro/kernels/assignment.py::_assignment_kernel
// (pl.pallas_call at :98, wrapper assignment_pallas at :120).  Shapes: X
// (N, d) shared by R centroid sets or (R, N, d); C (R, K, d); float32 ->
// labels int32 (R, N), min squared distance float32 (R, N).
//
// What bounds it on this card: operations, 2*N*K*d FMA operations at f32
// accuracy, 67 TFLOP/s on the CUDA cores; the bytes (N*d*4 in, N*8 out)
// are ~100x less.  The cross terms run on the CUDA cores in 8 x 8 register
// blocks (sweep_fp32.cuh): 64 FMAs per four shared loads, twice the 4 x 4
// blocks' ratio, with C transposed once per launch and streamed through a
// cp.async ring.  Each block owns one 64-row tile and all K centroids, so
// nothing is reduced across blocks: a relaunch is bitwise equal, and its
// distances are those of the fused kernels' sweep bit for bit.

#include "sweep_fp32.cuh"

namespace repro {

__global__ void __launch_bounds__(f8::kThreads, 2)
assign_tiles(const float* __restrict__ x, int64_t x_rstride,
             const float* __restrict__ ct, const float* __restrict__ csq,
             int n, int k, int d, int dc, int* __restrict__ labels,
             float* __restrict__ mind) {
  extern __shared__ float4 smem_raw[];
  const f8::Tile sm(reinterpret_cast<float*>(smem_raw), d, dc);
  const int r = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * f8::kRows;
  const int rows = n - row0 < f8::kRows ? (int)(n - row0) : f8::kRows;
  f8::load_rows(sm, x + r * x_rstride, row0, rows, d);
  f8::sweep(sm, ct + (int64_t)r * d * f8::pad_centroids(k),
            csq + (int64_t)r * k, k, d, dc);
  if (threadIdx.x < rows) {
    labels[(int64_t)r * n + row0 + threadIdx.x] = sm.lab[threadIdx.x];
    mind[(int64_t)r * n + row0 + threadIdx.x] = sm.mind[threadIdx.x];
  }
}

}  // namespace repro

using namespace repro;

// Floats of scratch one launch needs: C transposed, then |c|^2.
extern "C" long long assignment_scratch_floats(int r, int k, int d) {
  return (long long)r * d * f8::pad_centroids(k) + (long long)r * k;
}

// Launches |c|^2, the transpose of C and the assignment on `stream`;
// scratch holds assignment_scratch_floats(r, k, d) floats (16-byte
// aligned, as torch allocates).  Returns the first CUDA error (0 on
// success).
extern "C" int assignment_launch(const void* x, long long x_rstride,
                                 const void* c, int r, int n, int k, int d,
                                 void* scratch, void* labels, void* mind,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int dc = f8::stage_depth(d, optin);
  if (dc == 0) return (int)cudaErrorInvalidValue;
  const int k_pad = f8::pad_centroids(k);
  const int64_t ct_floats = (int64_t)r * d * k_pad;
  float* ct = static_cast<float*>(scratch);
  float* csq = ct + ct_floats;
  const float* cf = static_cast<const float*>(c);

  const int64_t rows = (int64_t)r * k;
  row_sqnorms<<<(unsigned)((rows + 7) / 8), kThreads, 0, s>>>(cf, rows, d, csq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (ct_floats + 255) / 256;
  f8::transpose_c<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      cf, r, k, d, k_pad, ct);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = f8::smem_bytes(d, dc);
  err = set_smem(assign_tiles, smem);
  if (err != cudaSuccess) return (int)err;
  assign_tiles<<<dim3(cdiv(n, f8::kRows), r), f8::kThreads, smem, s>>>(
      static_cast<const float*>(x), x_rstride, ct, csq, n, k, d, dc,
      static_cast<int*>(labels), static_cast<float*>(mind));
  return (int)cudaGetLastError();
}

extern "C" int assignment_max_features(int device) {
  return f8::max_features(device);
}

extern "C" const char* assignment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
