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
// many read, plus the indices, so device-memory bandwidth (3.35 TB/s); the
// main path's shapes move 0.1 to 50 MB, so at the small end the launch and
// the first loads' latency are most of it.  Design: one group of G threads
// copies one row, the group size chosen from the row class by the wrapper:
//   - rows whose width is a multiple of 4 and whose base is 16-byte aligned
//     move as 16-byte vectors (a warp moves 512 bytes per instruction);
//     G = the row's vector count, up to 32 (a 4-wide row is one thread);
//   - rows of 1 to 4 other elements: one thread per row (a warp handles 32
//     rows per index load);
//   - other widths (67, 131): a warp (or half-warp below 32) per row, 4-byte
//     elements.
// Each group reads its row's index once and issues the next row's index load
// before the current row's stores, so the loads stay in flight.  The grid is
// (blocks per batch row, B): the batch row is blockIdx.y, so no thread
// divides, and offsets are 32-bit (the wrapper refuses B*N*C or B*M*C of
// 2^31 or more).  The grid is sized to one wave of 8 blocks of 256 threads
// per SM, each group walking rows with a stride.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// T: the unit moved (uint4 or uint32_t); W: units per row; G: threads per row.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const T* __restrict__ values, const long long* __restrict__ idx, T* __restrict__ out,
    int N, int M, int W) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int groups = kThreads / G;
  const int stride = gridDim.x * groups;
  int m = blockIdx.x * groups + threadIdx.x / G;
  if (m >= M) return;
  const long long* bidx = idx + static_cast<long long>(b) * M;
  const T* src = values + static_cast<long long>(b) * N * W;
  T* dst = out + static_cast<long long>(b) * M * W;
  int j = static_cast<int>(__ldg(bidx + m));
  while (true) {
    const int next = m + stride;
    const int j_next = next < M ? static_cast<int>(__ldg(bidx + next)) : 0;
    const T* s = src + j * W;
    T* d = dst + m * W;
#pragma unroll 4
    for (int k = lane; k < W; k += G) d[k] = __ldg(s + k);
    if (next >= M) break;
    m = next;
    j = j_next;
  }
}

template <typename T, int G>
cudaError_t launch(const void* values, const void* idx, void* out, int B, int N, int M, int W,
                   cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int groups = kThreads / G;
  const int need = (M + groups - 1) / groups;               // blocks that give each group one row
  const int wave = (sms * kBlocksPerSm + B - 1) / B;         // one wave over the B batch rows
  const dim3 grid(need < wave ? need : wave, B);
  gather_rows_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const long long*>(idx), static_cast<T*>(out),
      N, M, W);
  return cudaGetLastError();
}

}  // namespace

// values (B,N,C) 4-byte elements, idx (B,M) int64 in [0, N), out (B,M,C);
// vec != 0 takes the 16-byte route, which needs C % 4 == 0 and 16-byte
// aligned values and out.  Requires B*N*C and B*M*C below 2^31 and B below
// 65536.  Returns cudaGetLastError() of the launch.
extern "C" int gather_rows_forward(const void* values, const void* idx, void* out, int B,
                                   int N, int M, int C, int vec, void* stream) {
  if (B <= 0 || M <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (C % 4 || reinterpret_cast<uintptr_t>(values) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const int W = C / 4;
    if (W == 1) return launch<uint4, 1>(values, idx, out, B, N, M, W, s);
    if (W == 2) return launch<uint4, 2>(values, idx, out, B, N, M, W, s);
    if (W <= 4) return launch<uint4, 4>(values, idx, out, B, N, M, W, s);
    if (W <= 8) return launch<uint4, 8>(values, idx, out, B, N, M, W, s);
    if (W <= 16) return launch<uint4, 16>(values, idx, out, B, N, M, W, s);
    return launch<uint4, 32>(values, idx, out, B, N, M, W, s);
  }
  if (C <= 4) return launch<uint32_t, 1>(values, idx, out, B, N, M, C, s);
  if (C <= 32) return launch<uint32_t, 16>(values, idx, out, B, N, M, C, s);
  return launch<uint32_t, 32>(values, idx, out, B, N, M, C, s);
}
