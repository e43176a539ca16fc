// The ordered row scatter — a kernel of the port's own for Hopper (sm_90a),
// with no TPU kernel of its own to replace.
//
// out[r] = the sum, in fp32 and in the order of `order`, of the rows
// rows[order[k]] for k in offsets[r] .. offsets[r + 1] - 1: the transpose of a
// row gather (out[r] gets every row whose index is r), given as a reverse
// table built on the card by a stable sort of the flat indices
// (kernels/gather_fused.py `reverse_table`), so each target row adds its
// sources in the order of their flat positions, the same order on every run
// and the order of `index_add_` on the CPU.  It is the card's route of
// `scatter_rows` (the backward of K2's gathers and of the training path's
// row gathers) and the db_table sum of the edge backward K6
// (csrc/edge_mlp_bwd.cu), whose main kernel writes each valid edge's
// bf16(dx) row to a per-edge buffer for it (launched there as
// edge_db_sum_kernel, the same sum under K6's own name).  On the TPU neither needs it:
// the JAX package's K6 accumulates db_table in a VMEM block over a grid that
// runs in order, and XLA's scatter-add on a TPU is sequential; on the card
// an atomic scatter adds in an order that changes from run to run.
//
// One thread per output element (r, c), c fastest, so a warp reads 32
// neighbouring channels of one source row; each thread walks its row's
// sources in order.  What bounds it on the H100: the bytes — each source row
// read once (bf16 or fp32), the order and offsets, each output written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void scatter_rows_in_order(
    const T* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ offsets, float* __restrict__ out, long long n_out, int C) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_out;
       i += stride) {
    const long long r = i / C;
    const int c = static_cast<int>(i - r * C);
    float s = 0.f;
    const long long end = offsets[r + 1];
    for (long long k = offsets[r]; k < end; ++k)
      s = __fadd_rn(s, to_float(rows[order[k] * C + c]));
    out[i] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) row_scatter_kernel(
    const T* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ offsets, float* __restrict__ out, long long n_out, int C) {
  scatter_rows_in_order(rows, order, offsets, out, n_out, C);
}

// The same sum under a name of its own, launched for K6's db_table, so that a
// profile tells K6's time from the scatters of `scatter_rows`.
__global__ void __launch_bounds__(256) edge_db_sum_kernel(
    const __nv_bfloat16* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ offsets, float* __restrict__ out, long long n_out, int C) {
  scatter_rows_in_order(rows, order, offsets, out, n_out, C);
}

}  // namespace

// rows (E, C) fp32 (bf16 = 0) or bf16 (bf16 = 1); order (N) int64, entries
// in [0, E); offsets (R + 1) int64, non-decreasing from 0 to at most N;
// out (R, C) fp32.  edge_db = 1 (bf16 rows only) launches the sum as
// edge_db_sum_kernel, K6's db_table.  Writes every row of out (0 where a row
// has no source).  Returns cudaGetLastError() after the launch.
extern "C" int row_scatter(const void* rows, int bf16, int edge_db, const void* order,
                           const void* offsets, void* out, long long R, int C, void* stream) {
  const long long n_out = R * C;
  if (n_out <= 0) return 0;
  if (C < 1 || (edge_db && !bf16)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n_out + 255) / 256;
  const int grid = static_cast<int>(want < 32LL * sms ? want : 32LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* o = static_cast<const long long*>(order);
  const long long* off = static_cast<const long long*>(offsets);
  float* y = static_cast<float*>(out);
  const auto* r16 = static_cast<const __nv_bfloat16*>(rows);
  if (edge_db)
    edge_db_sum_kernel<<<grid, 256, 0, s>>>(r16, o, off, y, n_out, C);
  else if (bf16)
    row_scatter_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(r16, o, off, y, n_out, C);
  else
    row_scatter_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(rows), o, off, y,
                                                    n_out, C);
  return static_cast<int>(cudaGetLastError());
}
