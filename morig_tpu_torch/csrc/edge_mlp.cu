// K1 — fused EdgeMLP tail for Hopper (sm_90a).
//
// Replaces the TPU kernel morig_tpu/kernels/edge_fused.py `fused_edge_mlp`
// (:102; body `_kernel` :74, tail `_edge_tail` :51), reached from every
// GCU/GCUMotion layer through nn/gcu.py EdgeMLP.  Per vertex v over its D
// neighbor-table edges:
//
//   out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))
//
// and 0 where no edge is valid.  a, b arrive in bf16; the W2 product takes
// bf16 operands with fp32 accumulation (WMMA 16x16x16); both LayerNorms are
// fp32 with var = E[x^2] - E[x]^2, eps 1e-6, over the true width.
//
// What bounds it on the H100: per edge row the kernel does 2*H1*H2 FLOPs but
// reads only one bf16 row of b (2*H1 bytes, mostly from L2: neighbors of a
// mesh are local), so at H >= 64 it is bounded by the tensor-core product and
// the shared-memory traffic feeding it, and at H = 16/32 by the gather
// latency of the b rows.  Design: the (D, H1) and (D, H2) per-edge
// intermediates never leave shared memory (only (V, H2) is written, as on
// the TPU); W2 stays in shared memory for a block's whole life (dynamic
// shared memory, up to 128 KB of bf16 at 256x256), and each block walks many
// vertex tiles (persistent grid) so W2 is fetched once per block, not once
// per tile.  The neighbor gather is a direct indexed load: no one-hot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;       // edge rows per vertex tile (D * vertices, padded)
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-6f;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) edge_mlp_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const float* __restrict__ g2, const float* __restrict__ be2,
    float* __restrict__ out, int B, int V, int D) {
  constexpr int C1 = (H1 + 31) / 32;            // channels per lane, layer 1
  constexpr int C2 = (H2 + 31) / 32;            // channels per lane, layer 2
  constexpr int MT = kRows / 16, NT = H2 / 16, KT = H1 / 16;
  constexpr int FR = (MT * NT + kWarps - 1) / kWarps;   // accumulators per warp

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* tile = smem + H1 * H2 * sizeof(__nv_bfloat16);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(tile);   // kRows x H1
  float* ys = reinterpret_cast<float*>(tile);                    // kRows x H2 (reuses hs)

  for (int i = threadIdx.x; i < H1 * H2; i += kThreads) w2s[i] = w2[i];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float g1r[C1], be1r[C1], b2r[C2], g2r[C2], be2r[C2];
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

  const int vpt = kRows / D;                    // vertices per tile
  const int tiles_per_batch = (V + vpt - 1) / vpt;
  const long long total = static_cast<long long>(B) * tiles_per_batch;

  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const int bi = static_cast<int>(t / tiles_per_batch);
    const int v0 = static_cast<int>(t % tiles_per_batch) * vpt;
    __syncthreads();   // previous tile's epilogue is done with ys; W2 is staged

    // ---- phase 1: h = bf16(LN1(relu(a[v] + b[nbr[v,d]]))) per edge row
    for (int r = warp; r < kRows; r += kWarps) {
      const int vl = r / D, d = r % D, v = v0 + vl;
      const long long e = (static_cast<long long>(bi) * V + v) * D + d;
      const bool valid = vl < vpt && v < V && mask[e];
      float x[C1];
      if (valid) {
        const long long j = nbr[e];
        const __nv_bfloat16* ar = a + (static_cast<long long>(bi) * V + v) * H1;
        const __nv_bfloat16* br = b + (static_cast<long long>(bi) * V + j) * H1;
        float s = 0.f, s2 = 0.f;
#pragma unroll
        for (int q = 0; q < C1; ++q) {
          const int c = lane + 32 * q;
          x[q] = c < H1 ? fmaxf(__bfloat162float(ar[c]) + __bfloat162float(br[c]), 0.f) : 0.f;
          s += x[q];
          s2 += x[q] * x[q];
        }
        const float mu = warp_sum(s) / H1;
        const float var = fmaxf(warp_sum(s2) / H1 - mu * mu, 0.f);
        const float inv = rsqrtf(var + kEps);
#pragma unroll
        for (int q = 0; q < C1; ++q) x[q] = (x[q] - mu) * inv * g1r[q] + be1r[q];
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
    __syncthreads();

    // ---- phase 2: (kRows x H1) @ (H1 x H2) on the tensor cores, fp32 sums
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
    __syncthreads();   // every warp is done reading hs before ys overwrites it
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int tix = warp + f * kWarps;
      if (tix < MT * NT) {
        const int m = tix / NT, n = tix % NT;
        wmma::store_matrix_sync(ys + m * 16 * H2 + n * 16, acc[f], H2, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // ---- phase 3: LN2(relu(y + b2)), masked max over each vertex's edges
    for (int vl = warp; vl < vpt; vl += kWarps) {
      const int v = v0 + vl;
      if (v >= V) continue;
      float best[C2];
#pragma unroll
      for (int q = 0; q < C2; ++q) best[q] = kNeg;
      int n_valid = 0;
      for (int d = 0; d < D; ++d) {
        const long long e = (static_cast<long long>(bi) * V + v) * D + d;
        if (!mask[e]) continue;
        ++n_valid;
        const int r = vl * D + d;
        float y[C2];
        float s = 0.f, s2 = 0.f;
#pragma unroll
        for (int q = 0; q < C2; ++q) {
          const int c = lane + 32 * q;
          y[q] = c < H2 ? fmaxf(ys[r * H2 + c] + b2r[q], 0.f) : 0.f;
          s += y[q];
          s2 += y[q] * y[q];
        }
        const float mu = warp_sum(s) / H2;
        const float var = fmaxf(warp_sum(s2) / H2 - mu * mu, 0.f);
        const float inv = rsqrtf(var + kEps);
#pragma unroll
        for (int q = 0; q < C2; ++q)
          best[q] = fmaxf(best[q], (y[q] - mu) * inv * g2r[q] + be2r[q]);
      }
      float* orow = out + (static_cast<long long>(bi) * V + v) * H2;
#pragma unroll
      for (int q = 0; q < C2; ++q) {
        const int c = lane + 32 * q;
        if (c < H2) orow[c] = n_valid > 0 ? best[q] : 0.f;
      }
    }
  }
}

template <int H>
cudaError_t launch(const void* a, const void* b, const void* nbr, const void* mask,
                   const void* w2, const void* b2, const void* g1, const void* be1,
                   const void* g2, const void* be2, void* out, int B, int V, int D,
                   cudaStream_t stream) {
  auto kern = edge_mlp_kernel<H, H>;
  const size_t hs_bytes = static_cast<size_t>(kRows) * H * sizeof(__nv_bfloat16);
  const size_t ys_bytes = static_cast<size_t>(kRows) * H * sizeof(float);
  const size_t smem = static_cast<size_t>(H) * H * sizeof(__nv_bfloat16) +
                      (hs_bytes > ys_bytes ? hs_bytes : ys_bytes);
  static bool configured = false;
  static int grid_cap = 0;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (err != cudaSuccess) return err;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
    configured = true;
  }
  const int vpt = kRows / D;
  const long long tiles = static_cast<long long>(B) * ((V + vpt - 1) / vpt);
  const int grid = static_cast<int>(tiles < grid_cap ? tiles : grid_cap);
  if (grid == 0) return cudaSuccess;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const long long*>(nbr), static_cast<const unsigned char*>(mask),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(g1), static_cast<const float*>(be1),
      static_cast<const float*>(g2), static_cast<const float*>(be2),
      static_cast<float*>(out), B, V, D);
  return cudaGetLastError();
}

}  // namespace

// a, b (B,V,H) bf16; nbr (B,V,D) int64; mask (B,V,D) bool; w2 (H,H) bf16
// row-major (in, out); b2, g1, be1, g2, be2 (H,) fp32; out (B,V,H) fp32.
// Requires H1 == H2 in {16, 32, 64, 128, 256}, 1 <= D <= 16 and every nbr
// entry in [0, V).  Returns cudaGetLastError() of the launch.
extern "C" int edge_mlp_forward(const void* a, const void* b, const void* nbr,
                                const void* mask, const void* w2, const void* b2,
                                const void* g1, const void* be1, const void* g2,
                                const void* be2, void* out, int B, int V, int D,
                                int H1, int H2, void* stream) {
  if (H1 != H2 || D < 1 || D > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H1) {
    case 16: return launch<16>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, s);
    case 32: return launch<32>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, s);
    case 64: return launch<64>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, s);
    case 128: return launch<128>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, s);
    case 256: return launch<256>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
