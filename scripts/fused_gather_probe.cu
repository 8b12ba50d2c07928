// Probe of the one-pass fused step: the design the fused kernel of
// src/repro_torch/kernels/csrc/fused_lloyd.cu set aside, kept here so that
// scripts/fused_gather_probe.py can time it against the port's two-pass
// step (the sweep, then the update kernel's segment sum).  Each block owns
// the 64-row tiles p, p + P, ... (P = 264 blocks, two on each SM), sweeps
// each with the port's 8 x 8 sweep (sweep_fp32.cuh), and adds the tile's
// stats, gathered while the tile is still in shared memory, into its own
// (K, d+1) partials in device memory (280 KB at K = 1000: more than a
// block's shared memory).  The gather: each distinct label of the tile is
// summed by one warp, lanes over columns, rows in order.  Built by that
// script with nvcc, -I the port's csrc/; not part of the port.
//
//   mode 0: sweep + gather (without the slab reduction)
//   mode 1: sweep only (labels, distances and energy, no stats)
//   mode 2: gather only, on the labels given in lab_in (no sweep)

#include "sweep_fp32.cuh"

namespace repro {

constexpr int kLeadBatch = 4;       // distinct labels a warp adds at once
constexpr int kColBatch = 4;        // 32-column blocks a lane adds at once
// Shared words of the gather's own: each leader's peer mask (64 bits), the
// rows that lead a label, and each warp's count of leaders.
constexpr int kGatherWords = 2 * f8::kRows + f8::kRows + 8;

__device__ __forceinline__ void zero_partials(float* __restrict__ pr, int k,
                                              int d) {
  for (int64_t e = threadIdx.x; e < (int64_t)k * (d + 1); e += kThreads)
    pr[e] = 0.f;
}

// Adds the tile's weighted one-hot stats into the slab's partials pr
// (K, d+1); column d is the weight total.  Reads sm.lab (a label outside
// [0, k) adds nothing), the weights w (kRows, zero past the rows) and the
// transposed X tile, which is still in shared memory.  `scratch` holds
// kGatherWords words, 8-byte aligned.
//
// Each distinct label of the tile is led by its first row, which knows
// its peers (the rows of its label) as a 64-bit mask.  A warp takes a
// leader at a time, its lanes 32 consecutive columns: they sum the peers'
// values in row order and read and write partial[label][columns], one
// coalesced 128-byte run per warp access, kLeadBatch leaders at once so
// that as many runs are in flight.  No two warps share a label and each
// label's rows go in row order, so no cell has two writers and the order
// of every addition is fixed by the data.
__device__ void gather_tile_stats(const f8::Tile& sm,
                                  const float* __restrict__ w, int rows,
                                  int k, int d, float* __restrict__ pr,
                                  float* scratch) {
  unsigned long long* peers = reinterpret_cast<unsigned long long*>(scratch);
  int* lead_row = reinterpret_cast<int*>(peers + f8::kRows);
  int* counts = lead_row + f8::kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = f8::kThreads / 32, cols = d + 1;
  // 1. each row's peers: four threads a row (warp q: rows 8q .. 8q+7), each
  // comparing 16 rows, OR-ed across the four; a row leads its label when
  // no earlier row has it
  const int i = threadIdx.x / 4, quarter = threadIdx.x % 4;
  const int l = sm.lab[i];
  const bool valid = i < rows && (unsigned)l < (unsigned)k;
  unsigned long long mine = 0ull;
  if (valid) {
    for (int j = 16 * quarter; j < min(16 * quarter + 16, rows); ++j)
      if (sm.lab[j] == l) mine |= 1ull << j;
  }
  mine |= __shfl_xor_sync(0xffffffffu, mine, 1);
  mine |= __shfl_xor_sync(0xffffffffu, mine, 2);
  const bool lead =
      valid && quarter == 0 && (mine & ((1ull << i) - 1ull)) == 0ull;
  const unsigned b = __ballot_sync(0xffffffffu, lead);
  if (lane == 0) counts[warp] = __popc(b);
  __syncthreads();
  int n_lead = 0, rank = 0;
  for (int q = 0; q < warps; ++q) {
    if (q == warp) rank = n_lead;
    n_lead += counts[q];
  }
  if (lead) {
    rank += __popc(b & ((1u << lane) - 1u));
    lead_row[rank] = i;
    peers[rank] = mine;
  }
  __syncthreads();
  // 2. warps over leaders, lanes over columns
  for (int c0 = 0; c0 < cols; c0 += 32 * kColBatch) {
    for (int q0 = warp; q0 < n_lead; q0 += warps * kLeadBatch) {
      int lab[kLeadBatch];
      unsigned long long m[kLeadBatch];
      float old[kLeadBatch][kColBatch], sum[kLeadBatch][kColBatch];
#pragma unroll
      for (int b = 0; b < kLeadBatch; ++b) {
        const int q = q0 + b * warps;
        lab[b] = q < n_lead ? sm.lab[lead_row[q]] : -1;
        m[b] = q < n_lead ? peers[q] : 0ull;
#pragma unroll
        for (int u = 0; u < kColBatch; ++u) {
          const int j = c0 + 32 * u + lane;
          old[b][u] = lab[b] >= 0 && j < cols
                          ? pr[(int64_t)lab[b] * cols + j] : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < kLeadBatch; ++b) {
        bool first = true;
        for (unsigned long long rest = m[b]; rest; rest &= rest - 1ull) {
          const int row = __ffsll((long long)rest) - 1;
          const float wr = w[row];
#pragma unroll
          for (int u = 0; u < kColBatch; ++u) {
            if (c0 + 32 * u >= cols) break;     // the same in every lane
            const int j = c0 + 32 * u + lane;
            const float v = j < d ? wr * sm.xs[j * f8::kXLd + row] : wr;
            sum[b][u] = first ? v : sum[b][u] + v;
          }
          first = false;
        }
#pragma unroll
        for (int u = 0; u < kColBatch; ++u) {
          const int j = c0 + 32 * u + lane;
          if (lab[b] >= 0 && j < cols)
            pr[(int64_t)lab[b] * cols + j] = old[b][u] + sum[b][u];
        }
      }
    }
  }
}

// Everything a tile contributes once sm.lab / sm.mind hold its
// assignment: the real rows' labels and distances to lab_out / mind_out
// (already offset to the tile's first row), the stats into pr, and the
// tile's weighted energy, returned in threads 0-31 (a fixed shuffle tree;
// 0 in the others).  scratch: the gather's kGatherWords words.
__device__ float emit_tile(const f8::Tile& sm, const float* __restrict__ w,
                           int rows, int k, int d, int* __restrict__ lab_out,
                           float* __restrict__ mind_out,
                           float* __restrict__ pr, float* scratch) {
  if (threadIdx.x < rows) {
    lab_out[threadIdx.x] = sm.lab[threadIdx.x];
    mind_out[threadIdx.x] = sm.mind[threadIdx.x];
  }
  float s = 0.f;
  if (threadIdx.x < 32) {
    for (int i = threadIdx.x; i < rows; i += 32) s += w[i] * sm.mind[i];
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  gather_tile_stats(sm, w, rows, k, d, pr, scratch);
  return s;
}

template <int kMode>
__global__ void __launch_bounds__(f8::kThreads, 2)
probe_step(const float* __restrict__ x, const float* __restrict__ ct,
           const float* __restrict__ csq, const int* __restrict__ lab_in,
           int n, int k, int d, int dc, int n_slabs,
           int* __restrict__ labels, float* __restrict__ mind,
           float* __restrict__ part, float* __restrict__ part_e) {
  constexpr bool kShared = true;
  extern __shared__ float4 smem_raw[];
  const f8::Tile sm(reinterpret_cast<float*>(smem_raw), d, dc, kShared);
  float* scratch = sm.extra;
  float* ws = scratch + kGatherWords;
  const int slab = blockIdx.x;
  float* pr = part + (int64_t)slab * k * (d + 1);
  if (kMode != 1) zero_partials(pr, k, d);
  float energy = 0.f;
  for (int tile = slab; tile < cdiv(n, f8::kRows); tile += n_slabs) {
    const int64_t row0 = (int64_t)tile * f8::kRows;
    const int rows = n - row0 < f8::kRows ? (int)(n - row0) : f8::kRows;
    __syncthreads();
    if (threadIdx.x < f8::kRows) {
      ws[threadIdx.x] = threadIdx.x < rows ? 1.f : 0.f;
      if (kMode == 2) {
        sm.lab[threadIdx.x] = threadIdx.x < rows ? lab_in[row0 + threadIdx.x] : 0;
        sm.mind[threadIdx.x] = 0.f;
      }
    }
    f8::load_rows(sm, x, row0, rows, d);
    if (kMode != 2)
      f8::sweep<false, kShared>(sm, ct, csq, k, d, dc, f8::Skip{});
    if (kMode == 1) {
      if (threadIdx.x < rows) {
        labels[row0 + threadIdx.x] = sm.lab[threadIdx.x];
        mind[row0 + threadIdx.x] = sm.mind[threadIdx.x];
      }
      if (threadIdx.x < 32) {
        float s = 0.f;
        for (int i = threadIdx.x; i < rows; i += 32) s += ws[i] * sm.mind[i];
        for (int off = 16; off; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        energy += s;
      }
    } else {
      energy += emit_tile(sm, ws, rows, k, d, labels + row0, mind + row0, pr,
                          scratch);
    }
  }
  if (threadIdx.x == 0) part_e[slab] = energy;
}

template <int kMode>
cudaError_t launch(const float* x, const float* ct, const float* csq,
                   const int* lab_in, int n, int k, int d, int dc,
                   int n_slabs, int* labels, float* mind,
                   float* part, float* part_e, cudaStream_t s) {
  const size_t smem =
      f8::smem_bytes(d, dc, kGatherWords + f8::kRows, true);
  cudaError_t err = set_smem(probe_step<kMode>, smem);
  if (err != cudaSuccess) return err;
  probe_step<kMode><<<n_slabs, f8::kThreads, smem, s>>>(
      x, ct, csq, lab_in, n, k, d, dc, n_slabs, labels, mind, part, part_e);
  return cudaGetLastError();
}

}  // namespace repro

using namespace repro;

// C transposed, then |c|^2.
extern "C" long long probe_scratch_floats(int k, int d) {
  return f8::scratch_floats(1, k, d);
}

// One problem (R = 1), weights 1.  Returns the first CUDA error.
extern "C" int probe_launch(int mode, const void* x, const void* c,
                            const void* lab_in, int n, int k, int d,
                            int n_slabs, void* scratch,
                            void* labels, void* mind, void* part,
                            void* part_e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int dc = f8::stage_depth(d, f8::optin_bytes(device),
                                 kGatherWords + f8::kRows, true);
  float *ct, *csq;
  err = f8::prepare_c(s, static_cast<const float*>(c), 1, k, d,
                      static_cast<float*>(scratch), &ct, &csq);
  if (err != cudaSuccess) return (int)err;
  auto launcher = mode == 0 ? launch<0> : mode == 1 ? launch<1> : launch<2>;
  return (int)launcher(static_cast<const float*>(x), ct, csq,
                       static_cast<const int*>(lab_in), n, k, d, dc, n_slabs,
                       static_cast<int*>(labels),
                       static_cast<float*>(mind), static_cast<float*>(part),
                       static_cast<float*>(part_e), s);
}
