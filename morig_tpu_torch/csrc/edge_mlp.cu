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
// B=4 (eight steps per unit left K5 1.2x behind K1 at H=256).  The step code
// itself is edge_tail.cuh's, which the backward K6 shares.
#include "edge_tail.cuh"

namespace {

using namespace morig_edge;

constexpr int kStepsPerUnit = 4;  // K5: at most this many steps per work unit

// K1 and K5 lay the step's ys buffer over hs.
template <int H1, int H2>
__device__ __forceinline__ Tail<H1, H2> forward_tail(
    unsigned char* smem, const __nv_bfloat16* w2, const float* b2, const float* g1,
    const float* be1, const float* g2, const float* be2) {
  unsigned char* step = smem + Tail<H1, H2>::kW2Bytes;
  return Tail<H1, H2>(reinterpret_cast<__nv_bfloat16*>(smem),
                      reinterpret_cast<__nv_bfloat16*>(step), reinterpret_cast<float*>(step),
                      w2, b2, g1, be1, g2, be2);
}

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
  Tail<H1, H2> tail = forward_tail<H1, H2>(smem, w2, b2, g1, be1, g2, be2);
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
  Tail<H1, H2> tail = forward_tail<H1, H2>(smem, w2, b2, g1, be1, g2, be2);
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
