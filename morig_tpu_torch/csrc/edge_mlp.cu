// K1 and K5 — fused EdgeMLP tail for Hopper (sm_90a).
//
// K1 replaces the TPU kernel morig_tpu/kernels/edge_fused.py `fused_edge_mlp`
// (:102; body `_kernel` :74, tail `_edge_tail` :51); K5 replaces
// `fused_edge_mlp_windowed` (:235; body `_kernel_windowed` :191).  Both are
// reached from every GCU/GCUMotion layer through nn/gcu.py EdgeMLP: K1 for
// any mesh, K5 for a mesh batch whose neighbour tables are local at the
// dispatch tile.  Per vertex v over its D neighbor-table edges:
//
//   out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))
//
// and 0 where no edge is valid.  a, b arrive in bf16; the W2 product takes
// bf16 operands with fp32 accumulation (WMMA 16x16x16); both LayerNorms are
// fp32 with var = E[x^2] - E[x]^2, eps 1e-6, over the true width.  K5 reads
// the neighbour row from its vertex tile's window: for tile i of TV rows (NB
// tiles) the 3*TV rows from ws = clip(i-1, 0, NB-3)*TV; a neighbour outside
// it reads a zero row, as the TPU kernel's one-hot finds no hit there.
//
// What bounds it on the H100: per edge row the kernel does 2*H1*H2 FLOPs but
// reads only one bf16 row of b (2*H1 bytes, mostly from L2: neighbors of a
// mesh are local), so at H >= 64 it is bounded by the tensor-core product and
// the shared-memory traffic feeding it, and at H = 16/32 by the gather
// latency of the b rows.  Design: the (D, H1) and (D, H2) per-edge
// intermediates never leave shared memory (only (V, H2) is written, as on
// the TPU); W2 stays in shared memory for a block's whole life (dynamic
// shared memory, up to 128 KB of bf16 at 256x256), and each block walks many
// work units (persistent grid) so W2 is fetched once per block, not once
// per unit.  The neighbor gather is a direct indexed load: no one-hot.
//
// K5's window: at H <= 64 a block stages its unit's 3*TV-row window of b in
// shared memory with 16-byte loads and gathers from there (48 KB at H=64,
// TV=128), which moves the gather of the narrow layers from L2 to shared
// memory at no cost in occupancy.  At H=128 the window (96 KB, 160 KB with W2
// and the step buffer) would leave one block per SM where K1 runs two, and
// at H=256 (192 KB) it does not fit beside the step's 64 KB fp32 buffer at
// all, so streaming W2 in k-slices would not make room; there K5 keeps W2
// resident, as K1 does, and reads the window's rows from global memory (L2).
// Measured on the H100 at the paths' shapes, staging at H=128 made K5 1.3x
// slower than reading from L2.  A work unit is a run of at most four of K1's
// 64-edge-row steps inside one vertex tile: several blocks share a tile's
// window, and the units are small enough to balance the persistent grid at
// B=4 (eight steps per unit left K5 1.2x behind K1 at H=256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kRows = 64;       // edge rows per step (D * vertices, padded)
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStepsPerUnit = 4;  // K5: at most this many steps per work unit
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may have
constexpr float kEps = 1e-6f;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The per-layer constants a block keeps in registers (each lane holds the
// channels lane + 32*q) and the shared-memory buffers of one step.
template <int H1, int H2>
struct Tail {
  static constexpr int C1 = (H1 + 31) / 32;     // channels per lane, layer 1
  static constexpr int C2 = (H2 + 31) / 32;     // channels per lane, layer 2
  static constexpr int MT = kRows / 16, NT = H2 / 16, KT = H1 / 16;
  static constexpr int FR = (MT * NT + kWarps - 1) / kWarps;   // accumulators per warp
  static constexpr size_t kW2Bytes = static_cast<size_t>(H1) * H2 * sizeof(__nv_bfloat16);
  static constexpr size_t kStepBytes =
      static_cast<size_t>(kRows) * (H1 * sizeof(__nv_bfloat16) > H2 * sizeof(float)
                                        ? H1 * sizeof(__nv_bfloat16) : H2 * sizeof(float));

  const __nv_bfloat16* w2s;
  __nv_bfloat16* hs;   // kRows x H1
  float* ys;           // kRows x H2 (reuses hs)
  float g1r[C1], be1r[C1], b2r[C2], g2r[C2], be2r[C2];

  // Stages W2 into shared memory at smem and loads the vectors.
  __device__ __forceinline__ Tail(unsigned char* smem, const __nv_bfloat16* w2,
                                  const float* b2, const float* g1, const float* be1,
                                  const float* g2, const float* be2) {
    __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(smem);
    for (int i = threadIdx.x; i < H1 * H2; i += kThreads) w[i] = w2[i];
    w2s = w;
    hs = reinterpret_cast<__nv_bfloat16*>(smem + kW2Bytes);
    ys = reinterpret_cast<float*>(smem + kW2Bytes);
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

  // One step: the D edges of the nv vertices v0.. of batch row bi.  Edge
  // (v, d) reads row j = nbr[v, d] as rows + (j - row0) * H1 when lo <= j < hi
  // and a zero row otherwise (rows is global or shared memory).
  __device__ __forceinline__ void step(int bi, int v0, int nv, int V, int D,
                                       const __nv_bfloat16* __restrict__ a,
                                       const __nv_bfloat16* rows, int lo, int hi, int row0,
                                       const long long* __restrict__ nbr,
                                       const unsigned char* __restrict__ mask,
                                       float* __restrict__ out) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    __syncthreads();   // the previous step's epilogue is done with ys; W2 is staged

    // ---- phase 1: h = bf16(LN1(relu(a[v] + b[nbr[v,d]]))) per edge row
    for (int r = warp; r < kRows; r += kWarps) {
      const int vl = r / D, d = r % D, v = v0 + vl;
      const long long e = (static_cast<long long>(bi) * V + v) * D + d;
      const bool valid = vl < nv && mask[e];
      float x[C1];
      if (valid) {
        const long long j = nbr[e];
        const __nv_bfloat16* ar = a + (static_cast<long long>(bi) * V + v) * H1;
        const __nv_bfloat16* br = j >= lo && j < hi ? rows + (j - row0) * H1 : nullptr;
        float s = 0.f, s2 = 0.f;
#pragma unroll
        for (int q = 0; q < C1; ++q) {
          const int c = lane + 32 * q;
          const float bv = br != nullptr && c < H1 ? __bfloat162float(br[c]) : 0.f;
          x[q] = c < H1 ? fmaxf(__bfloat162float(ar[c]) + bv, 0.f) : 0.f;
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
    for (int vl = warp; vl < nv; vl += kWarps) {
      const int v = v0 + vl;
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
};

// K1: the work unit is one step of vpt = kRows / D vertices.
template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) edge_mlp_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const float* __restrict__ g2, const float* __restrict__ be2,
    float* __restrict__ out, int B, int V, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tail<H1, H2> tail(smem, w2, b2, g1, be1, g2, be2);
  const int vpt = kRows / D;
  const int tiles_per_batch = (V + vpt - 1) / vpt;
  const long long total = static_cast<long long>(B) * tiles_per_batch;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const int bi = static_cast<int>(t / tiles_per_batch);
    const int v0 = static_cast<int>(t % tiles_per_batch) * vpt;
    tail.step(bi, v0, min(vpt, V - v0), V, D, a, b + static_cast<long long>(bi) * V * H1,
              0, V, 0, nbr, mask, out);
  }
}

// K5: the work unit is a run of steps inside one vertex tile of TV rows;
// with kStaged the block first copies the tile's window into shared memory.
template <int H1, int H2, bool kStaged>
__global__ void __launch_bounds__(kThreads) edge_mlp_windowed_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const float* __restrict__ g2, const float* __restrict__ be2,
    float* __restrict__ out, int B, int V, int D, int TV, int units_per_tile,
    int steps_per_unit) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tail<H1, H2> tail(smem, w2, b2, g1, be1, g2, be2);
  __nv_bfloat16* win =
      reinterpret_cast<__nv_bfloat16*>(smem + Tail<H1, H2>::kW2Bytes + Tail<H1, H2>::kStepBytes);
  const int vpt = kRows / D;
  const int NB = V / TV;
  const int steps_per_tile = (TV + vpt - 1) / vpt;
  const long long total = static_cast<long long>(B) * NB * units_per_tile;
  for (long long u = blockIdx.x; u < total; u += gridDim.x) {
    const int bi = static_cast<int>(u / (static_cast<long long>(NB) * units_per_tile));
    const int rem = static_cast<int>(u % (static_cast<long long>(NB) * units_per_tile));
    const int i = rem / units_per_tile, p = rem % units_per_tile;
    const int ws = min(max(i - 1, 0), NB - 3) * TV;
    const __nv_bfloat16* table = b + static_cast<long long>(bi) * V * H1;
    const __nv_bfloat16* rows = table;
    int row0 = 0;
    if (kStaged) {
      __syncthreads();   // the previous unit's steps are done reading win
      const uint4* src = reinterpret_cast<const uint4*>(table + static_cast<long long>(ws) * H1);
      uint4* dst = reinterpret_cast<uint4*>(win);
      const int n16 = 3 * TV * H1 * static_cast<int>(sizeof(__nv_bfloat16)) / 16;
      for (int k = threadIdx.x; k < n16; k += kThreads) dst[k] = src[k];
      rows = win;
      row0 = ws;
    }
    const int s_end = min((p + 1) * steps_per_unit, steps_per_tile);
    for (int s = p * steps_per_unit; s < s_end; ++s) {
      const int v0 = i * TV + s * vpt;
      tail.step(bi, v0, min(vpt, (i + 1) * TV - v0), V, D, a, rows, ws, ws + 3 * TV, row0,
                nbr, mask, out);
    }
  }
}

// The persistent grid of one kernel instance at one shared-memory size: its
// dynamic shared memory is set and its occupancy read once per size.
struct GridCache {
  size_t smem = 0;
  long long cap = 0;
};

template <class Kernel>
cudaError_t persistent_grid(Kernel kern, size_t smem, long long units, GridCache& cache,
                            int* grid) {
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

#define MORIG_EDGE_ARGS                                                                  \
  static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),            \
      static_cast<const long long*>(nbr), static_cast<const unsigned char*>(mask),       \
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),              \
      static_cast<const float*>(g1), static_cast<const float*>(be1),                     \
      static_cast<const float*>(g2), static_cast<const float*>(be2), static_cast<float*>(out)

template <int H>
cudaError_t launch(const void* a, const void* b, const void* nbr, const void* mask,
                   const void* w2, const void* b2, const void* g1, const void* be1,
                   const void* g2, const void* be2, void* out, int B, int V, int D,
                   cudaStream_t stream) {
  auto kern = edge_mlp_kernel<H, H>;
  const size_t smem = Tail<H, H>::kW2Bytes + Tail<H, H>::kStepBytes;
  const int vpt = kRows / D;
  static GridCache cache;
  int grid = 0;
  const cudaError_t err = persistent_grid(
      kern, smem, static_cast<long long>(B) * ((V + vpt - 1) / vpt), cache, &grid);
  if (err != cudaSuccess) return err;
  if (grid == 0) return cudaSuccess;
  kern<<<grid, kThreads, smem, stream>>>(MORIG_EDGE_ARGS, B, V, D);
  return cudaGetLastError();
}

template <int H, bool kStaged>
cudaError_t launch_windowed(const void* a, const void* b, const void* nbr, const void* mask,
                            const void* w2, const void* b2, const void* g1, const void* be1,
                            const void* g2, const void* be2, void* out, int B, int V, int D,
                            int TV, size_t smem, cudaStream_t stream) {
  auto kern = edge_mlp_windowed_kernel<H, H, kStaged>;
  const int vpt = kRows / D;
  const int steps_per_tile = (TV + vpt - 1) / vpt;
  const int units_per_tile = (steps_per_tile + kStepsPerUnit - 1) / kStepsPerUnit;
  const int steps_per_unit = (steps_per_tile + units_per_tile - 1) / units_per_tile;
  static GridCache cache;
  int grid = 0;
  const cudaError_t err = persistent_grid(
      kern, smem, static_cast<long long>(B) * (V / TV) * units_per_tile, cache, &grid);
  if (err != cudaSuccess) return err;
  if (grid == 0) return cudaSuccess;
  kern<<<grid, kThreads, smem, stream>>>(MORIG_EDGE_ARGS, B, V, D, TV, units_per_tile,
                                         steps_per_unit);
  return cudaGetLastError();
}

// The window is staged in shared memory at H <= 64 (where it fits beside W2
// and the step buffer); at H >= 128 its rows are read from global memory.
template <int H>
cudaError_t launch_windowed_h(const void* a, const void* b, const void* nbr, const void* mask,
                              const void* w2, const void* b2, const void* g1, const void* be1,
                              const void* g2, const void* be2, void* out, int B, int V, int D,
                              int TV, cudaStream_t stream) {
  const size_t base = Tail<H, H>::kW2Bytes + Tail<H, H>::kStepBytes;
  const size_t staged = base + static_cast<size_t>(3) * TV * H * sizeof(__nv_bfloat16);
  if (H <= 64 && staged <= static_cast<size_t>(kMaxSmem))
    return launch_windowed<H, true>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D,
                                    TV, staged, stream);
  return launch_windowed<H, false>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV,
                                   base, stream);
}

#undef MORIG_EDGE_ARGS

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

// K5: the same arguments plus the vertex tile TV; requires also V % TV == 0,
// V / TV >= 3 and TV % 8 == 0.
extern "C" int edge_mlp_windowed_forward(const void* a, const void* b, const void* nbr,
                                         const void* mask, const void* w2, const void* b2,
                                         const void* g1, const void* be1, const void* g2,
                                         const void* be2, void* out, int B, int V, int D,
                                         int H1, int H2, int TV, void* stream) {
  if (H1 != H2 || D < 1 || D > 16 || TV <= 0 || TV % 8 || V % TV || V / TV < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H1) {
    case 16:
      return launch_windowed_h<16>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV, s);
    case 32:
      return launch_windowed_h<32>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV, s);
    case 64:
      return launch_windowed_h<64>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV, s);
    case 128:
      return launch_windowed_h<128>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV,
                                    s);
    case 256:
      return launch_windowed_h<256>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV,
                                    s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
