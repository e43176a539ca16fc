// The fused EdgeMLP tail's step code, shared by K1's training twin
// (edge_mlp.cu `edge_mlp_kernel`, the training forward) and K6
// (edge_mlp_bwd.cu, the backward, which recomputes the forward).  Both
// compute the per-edge forward with the same instructions in the same order
// (the LayerNorm arithmetic is written with explicitly rounded intrinsics, so
// neither contracts it differently), which is what lets K6's max routing
// compare its recomputed per-edge outputs with the twin's by exact equality.
//
//   h[e]   = bf16(LN1(relu(a[v] + b[nbr[v,d]])))            (per edge row e)
//   y[e]   = h[e] @ W2                                        (bf16 WMMA, fp32 sums)
//   out[e] = LN2(relu(y[e] + b2))
//
// LayerNorms are fp32 with var = max(E[x^2] - E[x]^2, 0), eps 1e-6, over the
// true width; lane l of a warp holds channels l + 32 q.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace morig_edge {

using namespace nvcuda;

constexpr int kRows = 64;       // edge rows per step (D * vertices, padded)
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may have
constexpr float kEps = 1e-6f;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// LayerNorm statistics of one row (C values per lane, zeros past the true
// width n): mu and inv = rsqrt(max(E[x^2] - mu^2, 0) + eps).
template <int C>
__device__ __forceinline__ void ln_stats(const float (&x)[C], int n, float& mu, float& inv) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    s = __fadd_rn(s, x[q]);
    s2 = __fmaf_rn(x[q], x[q], s2);
  }
  const float fn = static_cast<float>(n);
  mu = __fdiv_rn(warp_sum(s), fn);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(warp_sum(s2), fn), __fmul_rn(mu, mu)), 0.f);
  inv = rsqrtf(__fadd_rn(var, kEps));
}

__device__ __forceinline__ float ln_norm(float x, float mu, float inv) {
  return __fmul_rn(__fsub_rn(x, mu), inv);
}

// The per-layer constants a block keeps in registers and the shared-memory
// buffers of one step: W2 (bf16, staged once per block), hs (kRows x H1
// bf16) and ys (kRows x H2 fp32; K1 and K5 lay it over hs).
template <int H1, int H2>
struct Tail {
  static constexpr int C1 = (H1 + 31) / 32;     // channels per lane, layer 1
  static constexpr int C2 = (H2 + 31) / 32;     // channels per lane, layer 2
  static constexpr int MT = kRows / 16, NT = H2 / 16, KT = H1 / 16;
  static constexpr int FR = (MT * NT + kWarps - 1) / kWarps;   // accumulators per warp
  static constexpr size_t kW2Bytes = static_cast<size_t>(H1) * H2 * sizeof(__nv_bfloat16);
  static constexpr size_t kHBytes = static_cast<size_t>(kRows) * H1 * sizeof(__nv_bfloat16);
  static constexpr size_t kYBytes = static_cast<size_t>(kRows) * H2 * sizeof(float);
  static constexpr size_t kStepBytes = kHBytes > kYBytes ? kHBytes : kYBytes;

  const __nv_bfloat16* w2s;
  __nv_bfloat16* hs;
  float* ys;
  float g1r[C1], be1r[C1], b2r[C2], g2r[C2], be2r[C2];

  // Stages W2 into shared memory at w2_smem and loads the vectors.
  __device__ __forceinline__ Tail(__nv_bfloat16* w2_smem, __nv_bfloat16* h_smem, float* y_smem,
                                  const __nv_bfloat16* w2, const float* b2, const float* g1,
                                  const float* be1, const float* g2, const float* be2)
      : w2s(w2_smem), hs(h_smem), ys(y_smem) {
    for (int i = threadIdx.x; i < H1 * H2; i += kThreads) w2_smem[i] = w2[i];
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < C1; ++j) {
      const int c = lane + 32 * j;
      g1r[j] = c < H1 ? g1[c] : 0.f;
      be1r[j] = c < H1 ? be1[c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < C2; ++j) {
      const int c = lane + 32 * j;
      b2r[j] = c < H2 ? b2[c] : 0.f;
      g2r[j] = c < H2 ? g2[c] : 0.f;
      be2r[j] = c < H2 ? be2[c] : 0.f;
    }
  }

  // relu(a[v] + b[j]) of one edge row into x (row j read from
  // rows + (j - row0) * H1 when lo <= j < hi, else a zero row).
  __device__ __forceinline__ void edge_input(const __nv_bfloat16* __restrict__ ar,
                                             const __nv_bfloat16* br, float (&x)[C1]) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int q = 0; q < C1; ++q) {
      const int c = lane + 32 * q;
      const float bv = br != nullptr && c < H1 ? __bfloat162float(br[c]) : 0.f;
      x[q] = c < H1 ? fmaxf(__fadd_rn(__bfloat162float(ar[c]), bv), 0.f) : 0.f;
    }
  }

  // Phase 1: hs rows = bf16(LN1(relu(a[v] + b[nbr[v,d]]))) for the D edges of
  // the nv vertices v0.. of batch row bi (zero rows for masked edges and past
  // nv * D).  With mu1/inv1 given, a valid row's LN1 statistics are kept.
  __device__ __forceinline__ void ln1_rows(int bi, int v0, int nv, int V, int D,
                                           const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* rows, int lo, int hi, int row0,
                                           const long long* __restrict__ nbr,
                                           const unsigned char* __restrict__ mask,
                                           float* mu1 = nullptr, float* inv1 = nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kRows; r += kWarps) {
      const int vl = r / D, d = r % D, v = v0 + vl;
      const long long e = (static_cast<long long>(bi) * V + v) * D + d;
      const bool valid = vl < nv && mask[e];
      float x[C1];
      if (valid) {
        const long long j = nbr[e];
        const __nv_bfloat16* ar = a + (static_cast<long long>(bi) * V + v) * H1;
        edge_input(ar, j >= lo && j < hi ? rows + (j - row0) * H1 : nullptr, x);
        float mu, inv;
        ln_stats(x, H1, mu, inv);
#pragma unroll
        for (int q = 0; q < C1; ++q) x[q] = __fmaf_rn(ln_norm(x[q], mu, inv), g1r[q], be1r[q]);
        if (mu1 != nullptr && lane == 0) {
          mu1[r] = mu;
          inv1[r] = inv;
        }
      } else {
#pragma unroll
        for (int q = 0; q < C1; ++q) x[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < C1; ++q) {
        const int c = lane + 32 * q;
        if (c < H1) hs[r * H1 + c] = __float2bfloat16(x[q]);
      }
    }
  }

  // Phase 2: ys = hs @ W2 on the tensor cores (16x16x16 bf16, fp32 sums).
  // Starts after the block's phase-1 writes are visible; ends synchronised.
  __device__ __forceinline__ void dense() {
    const int warp = threadIdx.x / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int tix = warp + f * kWarps;
      wmma::fill_fragment(acc[f], 0.f);
      if (tix < MT * NT) {
        const int m = tix / NT, n = tix % NT;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, hs + m * 16 * H1 + k * 16, H1);
          wmma::load_matrix_sync(fb, w2s + k * 16 * H2 + n * 16, H2);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
    }
    __syncthreads();   // every warp is done reading hs before ys (which may overlay it) is written
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int tix = warp + f * kWarps;
      if (tix < MT * NT) {
        const int m = tix / NT, n = tix % NT;
        wmma::store_matrix_sync(ys + m * 16 * H2 + n * 16, acc[f], H2, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  // LN2 of edge row r: t = relu(ys[r] + b2) (and s = ys[r] + b2 before the
  // relu), xn = (t - mu) * inv, out = xn * g2 + be2.
  __device__ __forceinline__ void ln2_row(int r, float (&s)[C2], float (&xn)[C2],
                                          float (&out)[C2], float& inv) const {
    const int lane = threadIdx.x % 32;
    float t[C2];
#pragma unroll
    for (int q = 0; q < C2; ++q) {
      const int c = lane + 32 * q;
      s[q] = c < H2 ? __fadd_rn(ys[r * H2 + c], b2r[q]) : 0.f;
      t[q] = fmaxf(s[q], 0.f);
    }
    float mu;
    ln_stats(t, H2, mu, inv);
#pragma unroll
    for (int q = 0; q < C2; ++q) {
      xn[q] = ln_norm(t[q], mu, inv);
      out[q] = __fmaf_rn(xn[q], g2r[q], be2r[q]);
    }
  }

  // The masked max over vertex vl's edges of LN2's outputs; n_valid counts
  // its valid edges.
  __device__ __forceinline__ void vertex_max(int vl, int D, const unsigned char* __restrict__ mrow,
                                             float (&best)[C2], int& n_valid) const {
#pragma unroll
    for (int q = 0; q < C2; ++q) best[q] = kNeg;
    n_valid = 0;
    for (int d = 0; d < D; ++d) {
      if (!mrow[d]) continue;
      ++n_valid;
      float s[C2], xn[C2], out[C2], inv;
      ln2_row(vl * D + d, s, xn, out, inv);
#pragma unroll
      for (int q = 0; q < C2; ++q) best[q] = fmaxf(best[q], out[q]);
    }
  }

  // One forward step (K1, K5): the D edges of the nv vertices v0.. of batch
  // row bi; out rows are the masked max, 0 where no edge is valid.
  __device__ __forceinline__ void step(int bi, int v0, int nv, int V, int D,
                                       const __nv_bfloat16* __restrict__ a,
                                       const __nv_bfloat16* rows, int lo, int hi, int row0,
                                       const long long* __restrict__ nbr,
                                       const unsigned char* __restrict__ mask,
                                       float* __restrict__ out) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();   // the previous step's epilogue is done with ys; W2 is staged
    ln1_rows(bi, v0, nv, V, D, a, rows, lo, hi, row0, nbr, mask);
    __syncthreads();
    dense();
    for (int vl = warp; vl < nv; vl += kWarps) {
      const long long v = static_cast<long long>(bi) * V + v0 + vl;
      float best[C2];
      int n_valid;
      vertex_max(vl, D, mask + v * D, best, n_valid);
      float* orow = out + v * H2;
#pragma unroll
      for (int q = 0; q < C2; ++q) {
        const int c = lane + 32 * q;
        if (c < H2) orow[c] = n_valid > 0 ? best[q] : 0.f;
      }
    }
  }
};

// The persistent grid of one kernel instance at one shared-memory size: its
// dynamic shared memory is set and its occupancy read once per size.
struct GridCache {
  size_t smem = 0;
  long long cap = 0;
};

template <class Kernel>
inline cudaError_t persistent_grid(Kernel kern, size_t smem, long long units,
                                   GridCache& cache, int* grid) {
  if (smem != cache.smem) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (err != cudaSuccess) return err;
    cache.cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    cache.smem = smem;
  }
  *grid = static_cast<int>(units < cache.cap ? units : cache.cap);
  return cudaSuccess;
}

}  // namespace morig_edge
