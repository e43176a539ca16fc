// K3 — batched row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel morig_tpu/kernels/gather_fused.py
// `_gather_fused_raw` (:88; body `_gather_kernel` :56), reached through
// `gather_rows` (:138) from nn/pointnet.py (SA grouping, FP interpolation):
//
//   out[b, m, :] = values[b, idx[b, m], :]
//
// for 4-byte elements (fp32 or int32), copied bit for bit.  The TPU kernel
// rebuilt the rows through a one-hot matmul with hi/lo bf16 halves (exact
// to ~2^-17); an indexed load is exact.
//
// What bounds it on the H100: pure data movement, M*C*4 bytes written and as
// many read (rows of 3 to 256 floats, neighbors mostly in L2), so it is
// bounded by device-memory bandwidth and, for 3-float rows, by the number of
// load instructions.  Design: one thread per output element with the
// channel fastest, so a warp writes consecutive addresses and reads whole
// source rows; a grid-stride loop keeps the grid at a few blocks per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const uint32_t* __restrict__ values, const long long* __restrict__ idx,
    uint32_t* __restrict__ out, int N, int M, int C, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / C;              // b * M + m
    const int c = static_cast<int>(i - row * C);
    const long long b = row / M;
    out[i] = values[(b * N + idx[row]) * C + c];
  }
}

}  // namespace

// values (B,N,C) 4-byte elements, idx (B,M) int64 in [0, N), out (B,M,C).
// Returns cudaGetLastError() of the launch.
extern "C" int gather_rows_forward(const void* values, const void* idx, void* out,
                                   int B, int N, int M, int C, void* stream) {
  const long long total = static_cast<long long>(B) * M * C;
  if (total == 0) return static_cast<int>(cudaSuccess);
  static int grid_cap = 0;
  if (grid_cap == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    grid_cap = (sms > 0 ? sms : 1) * 8;
  }
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < grid_cap ? blocks : grid_cap);
  gather_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const long long*>(idx),
      static_cast<uint32_t*>(out), N, M, C, total);
  return static_cast<int>(cudaGetLastError());
}
