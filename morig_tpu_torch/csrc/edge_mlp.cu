// K1 and K5 — fused EdgeMLP tail for Hopper (sm_90a).
//
// K1 replaces the TPU kernel morig_tpu/kernels/edge_fused.py `fused_edge_mlp`
// (:102; body `_kernel` :74, its tail :51); K5 replaces
// `fused_edge_mlp_windowed` (:235; body `_kernel_windowed` :191).  Both are
// reached from every GCU/GCUMotion layer through nn/gcu.py EdgeMLP: K1 for
// any mesh, K5 for a mesh batch whose neighbour tables are local at the
// dispatch tile.  Per vertex v over its D neighbor-table edges:
//
//   out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))
//
// and 0 where no edge is valid.  a, b arrive in bf16; the W2 product takes
// bf16 operands with fp32 accumulation; both LayerNorms are fp32 with var =
// E[x^2] - E[x]^2, eps 1e-6, over the true width.  K5 reads the neighbour row
// from its vertex tile's window: for tile i of TV rows (NB tiles) the 3*TV
// rows from ws = clip(i-1, 0, NB-3)*TV; a neighbour outside it reads a zero
// row, as the TPU kernel's one-hot finds no hit there.
//
// Which kernel runs where.  `fused_edge_mlp` runs K1,
// `edge_mlp_table_kernel`, for serving and as the forward of the trainable
// tail; the windowed dispatch runs K5, `edge_mlp_windowed_kernel`; both on
// edge_wgmma.cuh's step code.  The backward K6 (edge_mlp_bwd.cu) recomputes
// K1's per-edge outputs with the same step code, row parity and column
// split, and routes the max by exact equality with them.
//
// The design of K1 and K5 (step code in edge_wgmma.cuh): the TPU kernel's
// degree-major order.  A work unit is 64 vertices, run as one 64-row slab
// per neighbour slot; the product is `wgmma` m64nNk16 with LN1's output
// built straight into its A registers and W2 (in wgmma's K-major layout, one
// bulk TMA copy per block) as B, fp32 accumulators in registers, LN2 and the
// masked max applied to them in registers (a row's 4 lanes sum its
// statistics by shuffles).  Slabs with no valid edge in the unit, and units
// with none at all (padding), are skipped; masked edges and rows past the
// unit read nothing.
//
// K1 reads each live slab's neighbour rows from the mesh's whole table: a
// two-stage shared-memory ring, filled with 16-byte cp.async copies one slab
// ahead of the product (`ring_unit`), so the table never has to fit in
// shared memory (a B*T=20, V=1536, H=256 bf16 table is 15.7 MB, which L2
// holds).  At H=256 the two warpgroups of a block share a unit and split its
// columns (128 accumulators and 128 running maxima per thread would not fit
// in registers): each builds half of the slab's LN1 fragments, they trade
// halves through the slab's ring stage and LN2's row sums through `red`,
// under block barriers.  At H <= 128 each warpgroup runs its own unit on all
// H columns with its own ring and codes, under its own named barrier, so the
// two never wait on each other (a split would compute LN1 twice below H=64).
// What bounds K1 on the H100, as K5: LN1 and LN2 on the CUDA cores (two fp32
// passes over each row), not the products or the bytes; the ring hides the
// rows' latency behind the previous slab.
//
// K5 at H <= 128 stages its tile's whole 3*TV-row window with one bulk copy
// on an mbarrier (12-96 KB at TV=128) and builds the LN1 rows from shared
// memory; at H=256 the window (192 KB) does not fit beside W2 (128 KB), so it
// runs K1's split route on the window's rows.
#include "edge_wgmma.cuh"

namespace {

using morig_wg::GridCache;
using morig_wg::kMaxSmem;
using morig_wg::persistent_grid;

// The threads that run one unit: the whole block (kBlock) or warpgroup g.
template <bool kBlock>
__device__ __forceinline__ void unit_sync(int g) {
  if constexpr (kBlock) {
    __syncthreads();
  } else {
    morig_wg::wg_barrier(g);
  }
}

// One 64-vertex unit's live slabs (bit d of `live`) through a two-stage ring
// (`ring`, 2 x 64 x H bf16): slab d's neighbour rows, row codes[d * 64 + r]
// of `table` for each code >= 0, arrive by 16-byte cp.async copies one live
// slab ahead of its product; then this thread's rows r and r + 8 of the unit
// are stored (rows past nv are not).  kSplit: the block's two warpgroups run
// the unit together, each on half of the columns, under block barriers; else
// warpgroup g runs it alone on all H columns under its named barrier.  gt:
// the thread's index among those. Starts once `codes` is visible to them;
// waits for W2 (w2_bar, phase 0) after the first copies are issued.
template <int H, bool kSplit>
__device__ __forceinline__ void ring_unit(const int* codes, uint32_t live, __nv_bfloat16* ring,
                                          const __nv_bfloat16* table,
                                          const __nv_bfloat16* __restrict__ a, float* out,
                                          long long base, int nv, int D,
                                          const __nv_bfloat16* w2s, const morig_wg::Vecs<H>& vec,
                                          float2* red, uint64_t* w2_bar, int g, int gt) {
  namespace wg = morig_wg;
  constexpr int NW = kSplit ? H / 2 : H;                  // columns of one warpgroup
  constexpr int NT = kSplit ? wg::kThreads : wg::kWgThreads;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4, r = 16 * ((threadIdx.x % wg::kWgThreads) / 32) + lane / 4;
  const int n0 = kSplit ? g * NW : 0;
  auto fetch = [&](int d, int s) {
    __nv_bfloat16* dst = ring + s * wg::kUnit * H;
    for (int e = gt; e < wg::kUnit * (H / 8); e += NT) {
      const int rr = e / (H / 8), ch = e % (H / 8);
      const int code = codes[d * wg::kUnit + rr];
      if (code >= 0)
        wg::cp_async16(dst + rr * H + ch * 8, table + static_cast<long long>(code) * H + ch * 8);
    }
    wg::cp_async_commit();
  };
  auto next_live = [&](int d) {
    const uint32_t rest = d + 1 < 32 ? live & ~((2u << d) - 1u) : 0u;
    return rest ? __ffs(rest) - 1 : D;
  };
  int d = live ? __ffs(live) - 1 : D;
  if (d < D) fetch(d, 0);
  wg::mbar_wait(w2_bar, 0);
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
    unit_sync<kSplit>(g);   // slab d has landed; everyone is done with stage s + 1's last slab
    const int dn = next_live(d);
    if (dn < D) fetch(dn, (s + 1) & 1);
    __nv_bfloat16* st = ring + (s & 1) * wg::kUnit * H;
    const int c_lo = codes[d * wg::kUnit + r], c_hi = codes[d * wg::kUnit + r + 8];
    const bool ok_lo = c_lo != wg::kInvalid, ok_hi = c_hi != wg::kInvalid;
    any_lo |= ok_lo;
    any_hi |= ok_hi;
    wg::slab<H, NW, kSplit>(a_lo, c_lo >= 0 ? st + r * H : nullptr, ok_lo, a_hi,
                            c_hi >= 0 ? st + (r + 8) * H : nullptr, ok_hi, w2s, vec, n0, q, r, g,
                            red, reinterpret_cast<uint4*>(st), acc, best);
    d = dn;
  }
  wg::store_rows<NW>(r < nv ? out + (base + r) * H : nullptr, any_lo,
                     r + 8 < nv ? out + (base + r + 8) * H : nullptr, any_hi, best, n0, q);
}

// K1 (edge_wgmma.cuh's step code): a work item is one 64-vertex unit (bi, u)
// of the B x ceil(V / 64) units, the last of a mesh partial; its codes are
// the neighbours' rows of the whole table (ws = 0, wlen = V), gathered by
// `ring_unit`.  At H = 256 the block runs one unit at a time (kSplit), else
// each warpgroup runs its own: warpgroup g of block x takes units x + g *
// grid, x + (g + 2) * grid, ..., so that with fewer units than the grid's
// capacity each block takes one and every SM gets work.  Persistent grid;
// W2 stays in shared memory.
template <int H>
__global__ void __launch_bounds__(morig_wg::kThreads, (H <= 64 ? 2 : 1)) edge_mlp_table_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2l, const float* __restrict__ b2,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const float* __restrict__ g2, const float* __restrict__ be2,
    float* __restrict__ out, int B, int V, int D) {
  namespace wg = morig_wg;
  constexpr bool kSplit = H == 256;
  constexpr int kGroups = kSplit ? 1 : 2;                 // units a block runs at once
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, g = tid / wg::kWgThreads;
  const int gi = kSplit ? 0 : g;                          // this thread's unit slot
  const int gt = kSplit ? tid : tid % wg::kWgThreads;
  // shared memory: W2 | rings [kGroups][2][64][H] | vectors | codes [2][D * 64] | exchange |
  // live words | W2 barrier
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* rings = w2s + H * H;
  float* vecs = reinterpret_cast<float*>(rings + kGroups * 2 * wg::kUnit * H);
  int* codes = reinterpret_cast<int*>(vecs + 5 * H);
  float2* red = reinterpret_cast<float2*>(codes + 2 * D * wg::kUnit);
  uint32_t* livew = reinterpret_cast<uint32_t*>(red + 2 * wg::kUnit);
  uint64_t* bar = reinterpret_cast<uint64_t*>(livew + 8);
  const wg::Vecs<H> vec{vecs};
  if (tid == 0) {
    wg::mbar_init(bar);
    wg::mbar_init_fence();
  }
  wg::stage_vecs<H>(vecs, g1, be1, b2, g2, be2);
  __syncthreads();
  if (tid == 0) wg::bulk_load(w2s, w2l, H * H * sizeof(__nv_bfloat16), bar);
  int* cw = codes + gi * D * wg::kUnit;
  uint32_t* lw = livew + 4 * gi;
  __nv_bfloat16* ring = rings + gi * 2 * wg::kUnit * H;
  const int units = (V + wg::kUnit - 1) / wg::kUnit;
  const long long total = static_cast<long long>(B) * units;
  for (long long t = blockIdx.x + static_cast<long long>(gi) * gridDim.x; t < total;
       t += static_cast<long long>(gridDim.x) * kGroups) {
    const int bi = static_cast<int>(t / units), v0 = static_cast<int>(t % units) * wg::kUnit;
    const int nv = min(wg::kUnit, V - v0);
    const long long base = static_cast<long long>(bi) * V + v0;
    unit_sync<kSplit>(g);   // the last unit is done with the codes and the ring
    wg::unit_codes(cw, lw, kSplit ? wg::kThreads : wg::kWgThreads, gt, nbr, mask, base, nv, D,
                   0, V);
    unit_sync<kSplit>(g);
    uint32_t live = 0;
#pragma unroll
    for (int w = 0; w < 8 / kGroups; ++w) live |= lw[w];
    ring_unit<H, kSplit>(cw, live, ring, b + static_cast<long long>(bi) * V * H, a, out, base, nv,
                         D, w2s, vec, red, bar, g, gt);
  }
}

// K5 (edge_wgmma.cuh's step code).  Window route (kStream false, H <= 128):
// a work item is one vertex tile; one bulk copy stages its 3*TV-row window of
// b in shared memory, and the two warpgroups take the tile's 64-vertex units
// in turn, each unit's slabs on all H columns, gathering the neighbour rows
// from the window.  Stream route (kStream true, H = 256, or wherever the
// window does not fit): a work item is one unit, run by K1's split route
// (`ring_unit`) on the rows of its tile's window.  Both routes keep W2 in
// shared memory for the block's life and walk their items with a persistent
// grid.
template <int H, bool kStream>
__global__ void __launch_bounds__(morig_wg::kThreads, (H <= 64 ? 2 : 1)) edge_mlp_windowed_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2l, const float* __restrict__ b2,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const float* __restrict__ g2, const float* __restrict__ be2,
    float* __restrict__ out, int B, int V, int D, int TV) {
  namespace wg = morig_wg;
  extern __shared__ __align__(128) unsigned char smem[];
  const int NB = V / TV, wlen = 3 * TV, units = (TV + wg::kUnit - 1) / wg::kUnit;
  const int tid = threadIdx.x, g = tid / wg::kWgThreads;
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

  if constexpr (!kStream) {
    const int lane = tid % 32, q = lane % 4, r = 16 * ((tid % wg::kWgThreads) / 32) + lane / 4;
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
        float acc[H / 2], best[H / 2];
#pragma unroll
        for (int k = 0; k < H / 2; ++k) {
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
          wg::slab<H, H, false>(a_lo, c_lo >= 0 ? rows + c_lo * H : nullptr, ok_lo, a_hi,
                                c_hi >= 0 ? rows + c_hi * H : nullptr, ok_hi, w2s, vec, 0, q, r,
                                g, red, nullptr, acc, best);
        }
        wg::store_rows<H>(r < nv ? out + (base + r) * H : nullptr, any_lo,
                          r + 8 < nv ? out + (base + r + 8) * H : nullptr, any_hi, best, 0, q);
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
      __syncthreads();   // the last unit is done with the codes and the ring
      wg::unit_codes(codes, livew, wg::kThreads, tid, nbr, mask, base, nv, D, ws, wlen);
      __syncthreads();
      uint32_t live = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) live |= livew[w];
      ring_unit<H, true>(codes, live, rows, b + (static_cast<long long>(bi) * V + ws) * H, a, out,
                         base, nv, D, w2s, vec, red, &bars[0], g, tid);
    }
  }
}

#define MORIG_EDGE_ARGS                                                                  \
  static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),            \
      static_cast<const long long*>(nbr), static_cast<const unsigned char*>(mask),       \
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),              \
      static_cast<const float*>(g1), static_cast<const float*>(be1),                     \
      static_cast<const float*>(g2), static_cast<const float*>(be2), static_cast<float*>(out)

#define MORIG_EDGE_PARAMS                                                                   \
  const void *a, const void *b, const void *nbr, const void *mask, const void *w2,          \
      const void *b2, const void *g1, const void *be1, const void *g2, const void *be2,     \
      void *out

// Shared-memory bytes of the wgmma kernels (their carve order): W2, `row_slots` rows of H
// (K1's rings, K5's window or ring), the vectors, codes, exchange, live words and barriers.
template <int H>
size_t wgmma_smem(size_t row_slots, int D) {
  return (static_cast<size_t>(H) * H + row_slots * H) * sizeof(__nv_bfloat16) +
         5 * H * sizeof(float) + 2 * static_cast<size_t>(D) * morig_wg::kUnit * sizeof(int) +
         2 * morig_wg::kUnit * sizeof(float2) + 8 * sizeof(uint32_t) + 2 * sizeof(uint64_t);
}

template <int H>
cudaError_t launch_table(MORIG_EDGE_PARAMS, int B, int V, int D, cudaStream_t stream) {
  auto kern = edge_mlp_table_kernel<H>;
  constexpr int groups = H == 256 ? 1 : 2;                // units a block runs at once
  const size_t smem = wgmma_smem<H>(groups * 2 * morig_wg::kUnit, D);
  const long long units = static_cast<long long>(B) * ((V + morig_wg::kUnit - 1) / morig_wg::kUnit);
  static GridCache cache;
  int grid = 0;
  const cudaError_t err = persistent_grid(kern, smem, units, cache, &grid);
  if (err != cudaSuccess) return err;
  if (grid == 0) return cudaSuccess;
  kern<<<grid, morig_wg::kThreads, smem, stream>>>(MORIG_EDGE_ARGS, B, V, D);
  return cudaGetLastError();
}

template <int H>
size_t windowed_smem(bool stream, int D, int TV) {
  return wgmma_smem<H>(stream ? 2 * morig_wg::kUnit : 3 * static_cast<size_t>(TV), D);
}

template <int H, bool kStream>
cudaError_t launch_windowed(MORIG_EDGE_PARAMS, int B, int V, int D, int TV,
                            cudaStream_t stream) {
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
cudaError_t launch_windowed_h(MORIG_EDGE_PARAMS, int B, int V, int D, int TV,
                              cudaStream_t stream) {
  if constexpr (H <= 128) {
    if (windowed_smem<H>(false, D, TV) <= static_cast<size_t>(kMaxSmem))
      return launch_windowed<H, false>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D,
                                       TV, stream);
  }
  return launch_windowed<H, true>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D, TV,
                                  stream);
}

// launch<H>(...) for the width H1 == H2 in {16, 32, 64, 128, 256} and 1 <= D <= 16.
#define MORIG_EDGE_DISPATCH(launch, ...)                                                    \
  do {                                                                                      \
    if (H1 != H2 || D < 1 || D > 16) return static_cast<int>(cudaErrorInvalidValue);        \
    switch (H1) {                                                                           \
      case 16: return launch<16>(__VA_ARGS__);                                              \
      case 32: return launch<32>(__VA_ARGS__);                                              \
      case 64: return launch<64>(__VA_ARGS__);                                              \
      case 128: return launch<128>(__VA_ARGS__);                                            \
      case 256: return launch<256>(__VA_ARGS__);                                            \
      default: return static_cast<int>(cudaErrorInvalidValue);                              \
    }                                                                                       \
  } while (0)

#undef MORIG_EDGE_ARGS

}  // namespace

// K1.  a, b (B,V,H) bf16, 16-byte aligned; nbr (B,V,D) int64; mask (B,V,D)
// bool; w2 (H,H) in wgmma's layout (kernels/edge_fused.py `wgmma_w2_layout`);
// b2, g1, be1, g2, be2 (H,) fp32; out (B,V,H) fp32.  Requires H1 == H2 in
// {16, 32, 64, 128, 256}, 1 <= D <= 16 and every nbr entry in [0, V).
// Returns cudaGetLastError() of the launch.
extern "C" int edge_mlp_table_forward(MORIG_EDGE_PARAMS, int B, int V, int D, int H1, int H2,
                                      void* stream) {
  MORIG_EDGE_DISPATCH(launch_table, a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D,
                      static_cast<cudaStream_t>(stream));
}

// K5: K1's arguments plus the vertex tile TV.  Requires also V % TV == 0,
// V / TV >= 3 and TV % 8 == 0.
extern "C" int edge_mlp_windowed_forward(MORIG_EDGE_PARAMS, int B, int V, int D, int H1, int H2,
                                         int TV, void* stream) {
  if (TV <= 0 || TV % 8 || V % TV || V / TV < 3) return static_cast<int>(cudaErrorInvalidValue);
  MORIG_EDGE_DISPATCH(launch_windowed_h, a, b, nbr, mask, w2, b2, g1, be1, g2, be2, out, B, V, D,
                      TV, static_cast<cudaStream_t>(stream));
}
