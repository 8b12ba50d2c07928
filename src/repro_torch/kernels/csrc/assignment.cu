// Nearest-centroid assignment for Hopper (sm_90a): labels and squared
// distances, no cluster stats.
//
// Replaces the TPU kernel src/repro/kernels/assignment.py::_assignment_kernel
// (pl.pallas_call at :98, wrapper assignment_pallas at :120).  Shapes: X
// (N, d) shared by R centroid sets or (R, N, d); C (R, K, d); float32 ->
// labels int32 (R, N), min squared distance float32 (R, N).
//
// What bounds it on this card: 2*N*K*d FP32 operations on CUDA cores
// (67 TFLOP/s) against N*d*4 bytes in and N*8 bytes out (3.35 TB/s); at
// predict's chunk (16384 x 1000 x 69) the operations bound is ~100x the
// bytes bound.  The design is the fused kernel's sweep (nearest.cuh): 4 x 4
// register blocks fed by float4 shared loads.  Each block owns one 64-row
// tile, so there is nothing to reduce across blocks and no ordering issue.

#include "nearest.cuh"

namespace repro {

__global__ void __launch_bounds__(kThreads)
assign_tiles(const float* __restrict__ x, int64_t x_rstride,
             const float* __restrict__ c, const float* __restrict__ csq,
             int n, int k, int d, int* __restrict__ labels,
             float* __restrict__ mind) {
  extern __shared__ float4 smem_raw[];
  const Smem sm(reinterpret_cast<float*>(smem_raw), d);
  const int r = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * kTN;
  const int rows = n - row0 < kTN ? (int)(n - row0) : kTN;
  load_x_tile(sm, x + r * x_rstride, row0, rows, d);
  nearest_centroids(sm, c + (int64_t)r * k * d, csq + (int64_t)r * k, k, d);
  if (threadIdx.x < rows) {
    labels[(int64_t)r * n + row0 + threadIdx.x] = sm.lab[threadIdx.x];
    mind[(int64_t)r * n + row0 + threadIdx.x] = sm.mind[threadIdx.x];
  }
}

}  // namespace repro

using namespace repro;

// Launches |c|^2 and the assignment on `stream`; csq (R*K floats) is
// scratch.  Returns the first CUDA error (0 on success).
extern "C" int assignment_launch(const void* x, long long x_rstride,
                                 const void* c, int r, int n, int k, int d,
                                 void* csq, void* labels, void* mind,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = (int64_t)r * k;
  row_sqnorms<<<(unsigned)((rows + 7) / 8), kThreads, 0, s>>>(
      static_cast<const float*>(c), rows, d, static_cast<float*>(csq));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes(d);
  err = set_smem(assign_tiles, smem);
  if (err != cudaSuccess) return (int)err;
  assign_tiles<<<dim3(cdiv(n, kTN), r), kThreads, smem, s>>>(
      static_cast<const float*>(x), x_rstride, static_cast<const float*>(c),
      static_cast<const float*>(csq), n, k, d, static_cast<int*>(labels),
      static_cast<float*>(mind));
  return (int)cudaGetLastError();
}

extern "C" int assignment_max_features(int device) {
  return max_features(device);
}

extern "C" const char* assignment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
