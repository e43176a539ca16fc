// K2 and K4 — batched cosine top-k with and without row gather, for Hopper
// (sm_90a).
//
// K2 replaces the TPU kernel morig_tpu/kernels/knn_fused.py `_fused_raw` with
// `values` (:109; body `_knn_gather_kernel` :65 -> `_knn_body` :71), reached
// through `knn_batched` (:271) from nn/corrnet.py (vismask 1-NN) and
// nn/deformnet.py (visible voting, invisible completion).  K4 replaces
// `_fused_raw` without `values` (body `_knn_kernel` :61): the same kernel with
// the gather compiled out (kGather = false).  Per query row:
//
//   score_j = <q, c_j> (bf16 operands, fp32 accumulation), -1e30 where
//   cand_mask is false; the k largest in first-index-wins order; slots left
//   once fewer than k candidates are valid hold index 0 and score -1e30;
//   gathered[j] = values[idx_j] exactly (fp32).
//
// What bounds it on the H100: N*P*C multiply-adds per batch row against
// (N + P)*C*2 bytes read, so it is compute-bound, and the (N, P) similarity
// must not reach device memory (1.5 GB at B*T=160, V=1536, P=1024).  Design:
// one thread owns one query, holds it in registers, and keeps a running
// top-k in registers; the block streams candidate tiles through shared
// memory, where every thread reads the same candidate row (a broadcast).
// Candidates are visited in index order and a candidate enters the list only
// when strictly greater than the current k-th score, so among equal scores
// the smaller index stays ahead: the first-index-wins rule of the TPU
// kernel's argmax sweeps, with no cross-thread merge to get wrong.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;            // candidates per shared-memory tile
constexpr float kNeg = -1e30f;

template <int KM, int C, bool kGather>
__global__ void __launch_bounds__(kThreads) knn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cand,
    const unsigned char* __restrict__ mask, const float* __restrict__ values,
    long long* __restrict__ idx_out, float* __restrict__ score_out,
    float* __restrict__ gathered, int N, int P, int Cv, int k) {
  __shared__ __align__(16) float cs[kTile][C];
  __shared__ unsigned char ms[kTile];
  const int bi = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool active = n < N;

  float qr[C];
  const __nv_bfloat16* qp = q + (static_cast<long long>(bi) * N + (active ? n : 0)) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) qr[c] = __bfloat162float(qp[c]);

  float ts[KM];
  int ti[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    ts[j] = kNeg;
    ti[j] = 0;
  }

  for (int base = 0; base < P; base += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
      const int r = i / C, c = i % C, p = base + r;
      cs[r][c] = p < P ? __bfloat162float(cand[(static_cast<long long>(bi) * P + p) * C + c]) : 0.f;
    }
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      ms[i] = base + i < P ? mask[static_cast<long long>(bi) * P + base + i] : 0;
    __syncthreads();
    if (!active) continue;
    const int cnt = P - base < kTile ? P - base : kTile;
    for (int r = 0; r < cnt; ++r) {
      if (!ms[r]) continue;
      const float4* row = reinterpret_cast<const float4*>(cs[r]);
      float s = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 v = row[c4];
        s = fmaf(qr[4 * c4 + 0], v.x, s);
        s = fmaf(qr[4 * c4 + 1], v.y, s);
        s = fmaf(qr[4 * c4 + 2], v.z, s);
        s = fmaf(qr[4 * c4 + 3], v.w, s);
      }
      if (s > ts[KM - 1]) {            // strictly greater: earlier index wins ties
        ts[KM - 1] = s;
        ti[KM - 1] = base + r;
#pragma unroll
        for (int j = KM - 1; j > 0; --j) {
          if (ts[j] > ts[j - 1]) {
            const float fs = ts[j]; ts[j] = ts[j - 1]; ts[j - 1] = fs;
            const int fi = ti[j]; ti[j] = ti[j - 1]; ti[j - 1] = fi;
          }
        }
      }
    }
  }
  if (!active) return;

  const long long row = static_cast<long long>(bi) * N + n;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j >= k) break;
    idx_out[row * k + j] = ti[j];
    score_out[row * k + j] = ts[j];
    if (!kGather) continue;
    const float* src = values + (static_cast<long long>(bi) * P + ti[j]) * Cv;
    float* dst = gathered + (row * k + j) * Cv;
    for (int c = 0; c < Cv; ++c) dst[c] = src[c];
  }
}

template <int KM, bool kGather>
cudaError_t launch_c(const void* q, const void* cand, const void* mask,
                     const void* values, void* idx, void* score, void* gathered,
                     int B, int N, int P, int C, int Cv, int k, cudaStream_t s) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  if (grid.x == 0 || B == 0) return cudaSuccess;
#define MORIG_KNN_LAUNCH(CC)                                                      \
  knn_kernel<KM, CC, kGather><<<grid, kThreads, 0, s>>>(                                   \
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cand), \
      static_cast<const unsigned char*>(mask), static_cast<const float*>(values),  \
      static_cast<long long*>(idx), static_cast<float*>(score),                    \
      static_cast<float*>(gathered), N, P, Cv, k)
  if (C != 64) return cudaErrorInvalidValue;
  MORIG_KNN_LAUNCH(64);
#undef MORIG_KNN_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// q (B,N,C) bf16, cand (B,P,C) bf16, mask (B,P) bool, values (B,P,Cv) fp32;
// idx (B,N,k) int64, score (B,N,k) fp32, gathered (B,N,k,Cv) fp32.
// Requires C == 64 (CorrNet's embedding width), 1 <= k <= 8.  Returns cudaGetLastError().
extern "C" int knn_topk_gather(const void* q, const void* cand, const void* mask,
                               const void* values, void* idx, void* score,
                               void* gathered, int B, int N, int P, int C, int Cv,
                               int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return launch_c<1, true>(q, cand, mask, values, idx, score, gathered, B, N, P, C, Cv, k, s);
  if (k >= 2 && k <= 8)
    return launch_c<8, true>(q, cand, mask, values, idx, score, gathered, B, N, P, C, Cv, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4: the same without values and gathered.
extern "C" int knn_topk(const void* q, const void* cand, const void* mask, void* idx,
                        void* score, int B, int N, int P, int C, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return launch_c<1, false>(q, cand, mask, nullptr, idx, score, nullptr, B, N, P, C, 0, k, s);
  if (k >= 2 && k <= 8)
    return launch_c<8, false>(q, cand, mask, nullptr, idx, score, nullptr, B, N, P, C, 0, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
