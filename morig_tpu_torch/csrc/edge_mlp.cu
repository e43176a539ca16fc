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
// the traffic feeding it, and at H = 16/32 by the latency of the b rows.
//
// K1's design (edge_tail.cuh, shared with the backward K6): the (D, H1) and
// (D, H2) per-edge intermediates never leave shared memory (only (V, H2) is
// written, as on the TPU); W2 stays in shared memory for a block's whole
// life, each block walks many 64-edge-row steps (persistent grid), and the
// product is WMMA 16x16x16.  The neighbor gather is a direct indexed load.
//
// K5's design (redesigned for Hopper; step code in edge_wgmma.cuh): the TPU
// kernel's degree-major order.  A work unit is 64 vertices of one vertex
// tile, run as one 64-row slab per neighbour slot; the product is `wgmma`
// m64nNk16 with LN1's output built straight into its A registers and W2 (in
// wgmma's K-major layout, one bulk TMA copy per block) as B, fp32
// accumulators in registers, LN2 and the masked max applied to them in
// registers (a row's 4 lanes sum its statistics by shuffles).  Slabs with no
// valid edge in the unit, and units with none at all (padding), are skipped.
// At H <= 128 a block stages its tile's whole 3*TV-row window with one bulk
// copy on an mbarrier (12-96 KB at TV=128) and builds the LN1 rows from
// shared memory; at H=256 the window (192 KB) does not fit beside W2 (128
// KB), so the block gathers each live slab's rows with cp.async into a
// two-stage ring one slab ahead, and its two warpgroups split the 256
// columns (128 accumulators and 128 running maxima per thread would not fit
// in registers), exchanging the rows' LN2 partial sums.  K5's LayerNorm sums
// run in another order than K1's, so the two agree within the tolerance of
// bf16 rounding, not bit for bit.
#include "edge_tail.cuh"
#include "edge_wgmma.cuh"

namespace {

using namespace morig_edge;

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

// K5 (edge_wgmma.cuh's step code).  Window route (kStream false, H <= 128):
// a work item is one vertex tile; one bulk copy stages its 3*TV-row window of
// b in shared memory, and the two warpgroups take the tile's 64-vertex units
// in turn, each unit's slabs on all H columns, gathering the neighbour rows
// from the window.  Stream route (kStream true, H = 256, or wherever the
// window does not fit): a work item is one unit; both warpgroups run its
// slabs, each on half of the columns, and the block gathers each live slab's
// neighbour rows into a two-stage shared-memory ring with 16-byte cp.async
// copies, one slab ahead of the product; each warpgroup builds half of the
// slab's LN1 fragments and the two trade halves through the slab's stage.  Both routes keep W2 in shared
// memory for the block's life and walk their items with a persistent grid.
template <int H, bool kStream>
__global__ void __launch_bounds__(morig_wg::kThreads, (H <= 64 ? 2 : 1)) edge_mlp_windowed_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2l, const float* __restrict__ b2,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const float* __restrict__ g2, const float* __restrict__ be2,
    float* __restrict__ out, int B, int V, int D, int TV) {
  namespace wg = morig_wg;
  constexpr int NW = kStream ? H / 2 : H;          // columns of one warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  const int NB = V / TV, wlen = 3 * TV, units = (TV + wg::kUnit - 1) / wg::kUnit;
  const int tid = threadIdx.x, g = tid / wg::kWgThreads, lane = tid % 32;
  const int q = lane % 4, r = 16 * ((tid % wg::kWgThreads) / 32) + lane / 4;
  // shared memory: W2 | window (or the two-stage ring) | vectors | codes | exchange | live words |
  // barriers
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* rows = w2s + H * H;
  const int row_slots = kStream ? 2 * wg::kUnit : wlen;
  float* vecs = reinterpret_cast<float*>(rows + row_slots * H);
  int* codes = reinterpret_cast<int*>(vecs + 5 * H);                 // [2][D * 64]
  float2* red = reinterpret_cast<float2*>(codes + 2 * D * wg::kUnit);  // [2][64]
  uint32_t* livew = reinterpret_cast<uint32_t*>(red + 2 * wg::kUnit);  // [8]
  uint64_t* bars = reinterpret_cast<uint64_t*>(livew + 8);            // W2, window
  const wg::Vecs<H> vec{vecs};
  if (tid == 0) {
    wg::mbar_init(&bars[0]);
    wg::mbar_init(&bars[1]);
    wg::mbar_init_fence();
  }
  wg::stage_vecs<H>(vecs, g1, be1, b2, g2, be2);
  __syncthreads();
  if (tid == 0) wg::bulk_load(w2s, w2l, H * H * sizeof(__nv_bfloat16), &bars[0]);
  const int n0 = kStream ? g * NW : 0;

  if constexpr (!kStream) {
    uint32_t phase = 0;
    int* cw = codes + g * D * wg::kUnit;
    for (long long t = blockIdx.x; t < static_cast<long long>(B) * NB; t += gridDim.x, phase ^= 1) {
      const int bi = static_cast<int>(t / NB), i = static_cast<int>(t % NB);
      const int ws = min(max(i - 1, 0), NB - 3) * TV;
      __syncthreads();   // both warpgroups are done with the last window
      if (tid == 0)
        wg::bulk_load(rows, b + (static_cast<long long>(bi) * V + ws) * H,
                      wlen * H * sizeof(__nv_bfloat16), &bars[1]);
      for (int u = g; u < units; u += 2) {
        const int v0 = i * TV + u * wg::kUnit, nv = min(wg::kUnit, (i + 1) * TV - v0);
        const long long base = static_cast<long long>(bi) * V + v0;
        wg::wg_barrier(g);   // this warpgroup is done with its last unit's codes
        wg::unit_codes(cw, livew + 4 * g, wg::kWgThreads, tid % wg::kWgThreads, nbr, mask, base,
                       nv, D, ws, wlen);
        wg::wg_barrier(g);
        const uint32_t live = livew[4 * g] | livew[4 * g + 1] | livew[4 * g + 2] | livew[4 * g + 3];
        wg::mbar_wait(&bars[0], 0);
        wg::mbar_wait(&bars[1], phase);
        float acc[NW / 2], best[NW / 2];
#pragma unroll
        for (int k = 0; k < NW / 2; ++k) {
          acc[k] = 0.f;
          best[k] = wg::kNeg;
        }
        bool any_lo = false, any_hi = false;
        const __nv_bfloat16* a_lo = a + (base + r) * H;
        const __nv_bfloat16* a_hi = a_lo + 8 * H;
        for (int d = 0; d < D; ++d) {
          if (!(live >> d & 1u)) continue;
          const int c_lo = cw[d * wg::kUnit + r], c_hi = cw[d * wg::kUnit + r + 8];
          const bool ok_lo = c_lo != wg::kInvalid, ok_hi = c_hi != wg::kInvalid;
          any_lo |= ok_lo;
          any_hi |= ok_hi;
          wg::slab<H, NW, false>(a_lo, c_lo >= 0 ? rows + c_lo * H : nullptr, ok_lo, a_hi,
                                 c_hi >= 0 ? rows + c_hi * H : nullptr, ok_hi, w2s, vec, n0, q, r,
                                 g, red, nullptr, acc, best);
        }
        wg::store_rows<NW>(r < nv ? out + (base + r) * H : nullptr, any_lo,
                           r + 8 < nv ? out + (base + r + 8) * H : nullptr, any_hi, best, n0, q);
      }
    }
  } else {
    const long long total = static_cast<long long>(B) * NB * units;
    for (long long t = blockIdx.x; t < total; t += gridDim.x) {
      const int bi = static_cast<int>(t / (static_cast<long long>(NB) * units));
      const int rem = static_cast<int>(t % (static_cast<long long>(NB) * units));
      const int i = rem / units, u = rem % units;
      const int ws = min(max(i - 1, 0), NB - 3) * TV;
      const int v0 = i * TV + u * wg::kUnit, nv = min(wg::kUnit, (i + 1) * TV - v0);
      const long long base = static_cast<long long>(bi) * V + v0;
      const __nv_bfloat16* window = b + (static_cast<long long>(bi) * V + ws) * H;
      __syncthreads();   // the last unit is done with the codes and the ring
      wg::unit_codes(codes, livew, wg::kThreads, tid, nbr, mask, base, nv, D, ws, wlen);
      __syncthreads();
      uint32_t live = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) live |= livew[w];
      // gather slab d's neighbour rows into ring stage s (16 bytes a copy)
      auto fetch = [&](int d, int s) {
        __nv_bfloat16* dst = rows + s * wg::kUnit * H;
        for (int e = tid; e < wg::kUnit * (H / 8); e += wg::kThreads) {
          const int rr = e / (H / 8), ch = e % (H / 8);
          const int code = codes[d * wg::kUnit + rr];
          if (code >= 0) wg::cp_async16(dst + rr * H + ch * 8, window + code * H + ch * 8);
        }
        wg::cp_async_commit();
      };
      auto next_live = [&](int d) {
        const uint32_t rest = d + 1 < 32 ? live & ~((2u << d) - 1u) : 0u;
        return rest ? __ffs(rest) - 1 : D;
      };
      int d = live ? __ffs(live) - 1 : D;
      if (d < D) fetch(d, 0);
      wg::mbar_wait(&bars[0], 0);
      float acc[NW / 2], best[NW / 2];
#pragma unroll
      for (int k = 0; k < NW / 2; ++k) {
        acc[k] = 0.f;
        best[k] = wg::kNeg;
      }
      bool any_lo = false, any_hi = false;
      const __nv_bfloat16* a_lo = a + (base + r) * H;
      const __nv_bfloat16* a_hi = a_lo + 8 * H;
      for (int s = 0; d < D; ++s) {
        wg::cp_async_wait_all();
        __syncthreads();   // slab d has landed; everyone is done with stage s + 1's last slab
        const int dn = next_live(d);
        if (dn < D) fetch(dn, (s + 1) & 1);
        __nv_bfloat16* st = rows + (s & 1) * wg::kUnit * H;
        const int c_lo = codes[d * wg::kUnit + r], c_hi = codes[d * wg::kUnit + r + 8];
        const bool ok_lo = c_lo != wg::kInvalid, ok_hi = c_hi != wg::kInvalid;
        any_lo |= ok_lo;
        any_hi |= ok_hi;
        wg::slab<H, NW, true>(a_lo, c_lo >= 0 ? st + r * H : nullptr, ok_lo, a_hi,
                              c_hi >= 0 ? st + (r + 8) * H : nullptr, ok_hi, w2s, vec, n0, q, r, g,
                              red, reinterpret_cast<uint4*>(st), acc, best);
        d = dn;
      }
      wg::store_rows<NW>(r < nv ? out + (base + r) * H : nullptr, any_lo,
                         r + 8 < nv ? out + (base + r + 8) * H : nullptr, any_hi, best, n0, q);
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

// Shared-memory bytes of K5's routes (the kernel's carve order).
template <int H>
size_t windowed_smem(bool stream, int D, int TV) {
  const size_t row_slots = stream ? 2 * morig_wg::kUnit : 3 * static_cast<size_t>(TV);
  return (static_cast<size_t>(H) * H + row_slots * H) * sizeof(__nv_bfloat16) +
         5 * H * sizeof(float) + 2 * static_cast<size_t>(D) * morig_wg::kUnit * sizeof(int) +
         2 * morig_wg::kUnit * sizeof(float2) + 8 * sizeof(uint32_t) + 2 * sizeof(uint64_t);
}

template <int H, bool kStream>
cudaError_t launch_windowed(const void* a, const void* b, const void* nbr, const void* mask,
                            const void* w2, const void* b2, const void* g1, const void* be1,
                            const void* g2, const void* be2, void* out, int B, int V, int D,
                            int TV, cudaStream_t stream) {
  auto kern = edge_mlp_windowed_kernel<H, kStream>;
  const size_t smem = windowed_smem<H>(kStream, D, TV);
  const long long tiles = static_cast<long long>(B) * (V / TV);
  const long long items = kStream ? tiles * ((TV + morig_wg::kUnit - 1) / morig_wg::kUnit) : tiles;
  static GridCache cache;
  int grid = 0;
  const cudaError_t err = persistent_grid(kern, smem, items, cache, &grid);
  if (err != cudaSuccess) return err;
  if (grid == 0) return cudaSuccess;
  kern<<<grid, morig_wg::kThreads, smem, stream>>>(MORIG_EDGE_ARGS, B, V, D, TV);
  return cudaGetLastError();
}

// The window route where the window fits beside W2 (H <= 128), else the
// stream route.
template <int H>
cudaError_t launch_windowed_h(const void* a, const void* b, const void* nbr, const void* mask,
                              const void* w2, const void* b2, const void* g1, const void* be1,
                              const void* g2, const void* be2, void* out, int B, int V, int D,
                              int TV, cudaStream_t stream) {
  if constexpr (H <= 128) {
    if (windowed_smem<H>(false, D, TV) <= static_cast<size_t>(kMaxSmem))
      return launch_windowed<H, false>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D,
                                       TV, stream);
  }
  return launch_windowed<H, true>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV,
                                  stream);
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

// K5: the same arguments plus the vertex tile TV, but w2 in wgmma's layout
// (kernels/edge_fused.py `wgmma_w2_layout`); a and b 16-byte aligned.
// Requires also V % TV == 0, V / TV >= 3 and TV % 8 == 0.
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
