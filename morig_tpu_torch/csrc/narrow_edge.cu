// KN and KNB — the fp32 training tail of the edge layers narrower than 128,
// forward and backward, for Hopper (sm_90a).
//
// They replace no TPU kernel: the JAX package trains an edge layer below its
// kernels' width rule (H1 >= 128, morig_tpu/nn/gcu.py `_fusable`) on its fp32
// XLA tail (morig_tpu/nn/gcu.py EdgeMLP, :316-320), which XLA fuses on a
// TPU.  The port's counterpart is one fused pass each way
// (kernels/narrow_edge.py).  Per vertex v over its D <= 16 table edges:
//
//   out[v] = max_{d valid} LN2(relu(LN1(relu(a[v] + b[nbr[v,d]])) @ W2 + b2))
//
// and 0 where no edge is valid, everything in fp32 (no TF32, no bf16), both
// LayerNorms with the two-pass statistics of the JAX package's `_ln`: mu =
// mean(x), var = mean((x - mu)^2), eps 1e-6.  H = H1 = H2 in {8, 16, 32, 64}.
//
// Work: a tile of kRows = 64 edge rows, the D edges of 64 / D consecutive
// vertices of the flattened (B*V) table (row r = edge r % D of vertex r / D);
// a block of 256 threads walks tiles over a persistent grid.  Per tile:
//   1. LN1 (a row to a group of H/4 lanes, 4 contiguous channels a lane, a
//      and b read as 16-byte loads): x = a[v] + b[nbr], r = relu(x), its sum
//      and then its sum of squared deviations reduced by an xor butterfly
//      over the group (every lane ends with the same bits), h = LN1(r) into
//      shared memory;
//   2. s = h W2 + b2, a register tile of rows x 4 columns a thread, one fmaf
//      chain from 0 per output in k order 0 .. H-1, W2 resident in shared
//      memory;
//   3. LN2's statistics of t = relu(s), as LN1's.
// `recompute_tile` is this, and KN and KNB's recompute both call it, so the
// backward's route by exact equality sees the forward's bits.  KN then takes
// each (vertex, 4 channels)'s max over its valid edges (the max is exact, so
// its order does not matter).  Every per-row value depends on its row's
// inputs alone, never on B, on the padding or on the grid: the rows of a
// rank of a data-parallel step compute as in the whole batch.
//
// KNB, after the same recompute: (4) the max backward, per (vertex, 4
// channels): the max and the count of valid edges equal to it (the count
// restarts where the max rises), dout / count to each of them (jnp.max's
// rule; 0 where the vertex has no valid edge); (5) the LN2 backward, dt,
// and ds = dt relu'(s) with relu'(0) = 1/2 (jnp.maximum's gradient, which
// the JAX tail differentiates); (6) dh = ds W2^T (W2^T resident too) and
// the tile's dW2 += h^T ds; (7) the LN1 backward and dx = dr relu'(x), each
// valid edge's dx row written to a per-edge buffer that the ordered row
// scatter (csrc/row_scatter.cu, launched by the wrapper as
// narrow_db_sum_kernel over the batch's masked reverse table) sums into
// db_table in (b, v, d) order; (8) da[v] = the sum of v's dx rows, d in
// order.  dW2, db2, dg1, dbe1, dg2 and dbe2 are per-thread sums over the
// block's rows, added over the threads in a fixed order into the block's
// partial, then over the blocks in block order by `narrow_fold_kernel`.  No
// atomics: a call repeats bit for bit on a grid that is a function of the
// shapes (min(tiles, kBwdBlocks)).
//
// What bounds it on the H100: at B=4, V=2048, D=16, H=64 the forward does
// 2 E H^2 fp32 FLOPs over E edge rows (about 1 GFLOP) against about 6 MB
// of inputs and outputs, so the fp32 FMA rate (67 TFLOP/s without the
// tensor cores, which TF32 would use and the JAX tail does not); the
// backward three such products.  The products read h and W2 from shared
// memory as 16-byte loads, 4 x (rows per thread) FMAs a pair of loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // edge rows per tile
constexpr float kEps = 1e-6f;
constexpr float kNeg = -1e30f;
constexpr int kFwdBlocks = 528;      // KN's grid cap: 4 blocks on each of the H100's 132 SMs
constexpr int kBwdBlocks = 264;      // KNB's: 2 on each; fixed, so its partials are too

// Explicitly rounded arithmetic throughout: KN and KNB inline the same
// expressions in two kernels, and no contraction may differ between them.
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float fma_(float x, float y, float z) { return __fmaf_rn(x, y, z); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void unpack(const float4& f, float (&v)[4]) {
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// The sum over a group of G consecutive lanes (G a power of two dividing 32)
// by an xor butterfly: every lane of the group ends with the same bits.  All
// 32 lanes of the warp call it.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) x = add(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The two-pass statistics of a row held 4 values a lane over the group's
// H/4 lanes: mu = sum / H, inv = rsqrt(sum (x - mu)^2 / H + eps).
template <int H>
__device__ __forceinline__ void ln_stats(const float (&x)[4], float& mu, float& inv) {
  constexpr int G = H / 4;
  mu = mul(group_sum<G>(add(add(add(x[0], x[1]), x[2]), x[3])), 1.f / H);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float d = sub(x[j], mu);
    ss = fma_(d, d, ss);
  }
  inv = rsqrtf(add(mul(group_sum<G>(ss), 1.f / H), kEps));
}

__device__ __forceinline__ float ln_xn(float x, float mu, float inv) { return mul(sub(x, mu), inv); }
// The LayerNorm's output: KN's outputs and KNB's route compare these bits.
__device__ __forceinline__ float ln_affine(float x, float mu, float inv, float g, float be) {
  return fma_(ln_xn(x, mu, inv), g, be);
}

// relu'(x) as jnp.maximum(x, 0) gives it: 1 above 0, 1/2 at 0, 0 below.
__device__ __forceinline__ float relu_grad(float x) { return x > 0.f ? 1.f : x == 0.f ? 0.5f : 0.f; }

// Shared memory of one block, in floats: W2 (H x H, row k = input channel
// k), [KNB: W2^T], the vectors (g1 | be1 | b2 | g2 | be2), row buffers of
// kRows x kLd (bh: h; bs: s, then ds; [KNB: bc: dy, then dh, then dx]), the
// rows' LN statistics and their flat b row (-1: a masked edge or a row past
// the tile).  KNB's end-of-grid reduction reuses the row buffers, sized to
// hold it.
template <int H, bool kBwd>
struct Layout {
  static constexpr int kLd = H + 4;                    // row stride: rows on other banks
  static constexpr int kW2 = 0;
  static constexpr int kW2t = kW2 + H * H;
  static constexpr int kVec = kW2t + (kBwd ? H * H : 0);
  static constexpr int kBuf = kVec + 5 * H;
  static constexpr int kBufs = (kBwd ? 3 : 2) * kRows * kLd;
  static constexpr int kSlots = kThreads / (H / 4);    // rows the row phases take at once
  // KNB's end: the vectors' row slots (5 H x kSlots), after dW2's parts (a
  // 4 x 4 tile a thread: 16 x kThreads)
  static constexpr int kReduce = kBwd ? 5 * H * kSlots : 0;
  static_assert(!kBwd || kReduce >= 16 * kThreads, "dW2's parts fit");
  static constexpr int kStats = kBuf + (kBufs > kReduce ? kBufs : kReduce);
  static constexpr int kRow = kStats + 4 * kRows;      // then kRows long longs
  static constexpr size_t kBytes = kRow * sizeof(float) + kRows * sizeof(long long);
  static_assert(kRow % 2 == 0, "8-byte aligned row table");
};

template <int H, bool kBwd>
struct Smem {
  using L = Layout<H, kBwd>;
  float* base;
  __device__ float* w2() const { return base + L::kW2; }
  __device__ float* w2t() const { return base + L::kW2t; }
  __device__ const float* g1() const { return base + L::kVec; }
  __device__ const float* be1() const { return base + L::kVec + H; }
  __device__ const float* b2() const { return base + L::kVec + 2 * H; }
  __device__ const float* g2() const { return base + L::kVec + 3 * H; }
  __device__ const float* be2() const { return base + L::kVec + 4 * H; }
  __device__ float* buf(int i) const { return base + L::kBuf + i * kRows * L::kLd; }
  __device__ float* row(int i, int r) const { return buf(i) + r * L::kLd; }
  __device__ float* reduce() const { return base + L::kBuf; }
  __device__ float* mu1() const { return base + L::kStats; }
  __device__ float* inv1() const { return base + L::kStats + kRows; }
  __device__ float* mu2() const { return base + L::kStats + 2 * kRows; }
  __device__ float* inv2() const { return base + L::kStats + 3 * kRows; }
  __device__ long long* brow() const { return reinterpret_cast<long long*>(base + L::kRow); }
};

// W2 (and with kBwd its transpose) and the vectors into shared memory.
template <int H, bool kBwd>
__device__ __forceinline__ void stage_params(const Smem<H, kBwd>& sm, const float* __restrict__ w2,
                                             const float* __restrict__ vecs) {
  for (int i = threadIdx.x; i < H * H / 4; i += kThreads)
    reinterpret_cast<float4*>(sm.w2())[i] = reinterpret_cast<const float4*>(w2)[i];
  if constexpr (kBwd)
    for (int i = threadIdx.x; i < H * H; i += kThreads) sm.w2t()[(i % H) * H + i / H] = w2[i];
  for (int i = threadIdx.x; i < 5 * H; i += kThreads) sm.base[Layout<H, kBwd>::kVec + i] = vecs[i];
}

// The tile's row table: flat b row of each edge row (batch row * V + nbr),
// -1 for a masked edge or a row past the tile's nv * D.  Returns (to every
// thread) whether some row is valid.
template <int H, bool kBwd>
__device__ __forceinline__ bool tile_rows(const Smem<H, kBwd>& sm, const long long* __restrict__ nbr,
                                          const unsigned char* __restrict__ mask, long long v0,
                                          int nv, int D, int V) {
  int live = 0;
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    long long br = -1;
    if (r < nv * D) {
      const long long e = v0 * D + r;
      if (mask[e]) br = (v0 + r / D) / V * V + nbr[e];
    }
    sm.brow()[r] = br;
    live |= br >= 0;
  }
  return __syncthreads_or(live);
}

// Buffer dst = buffer src x W (+ bias) over a tile's kRows rows, W (H x H,
// row k = input channel k) in shared memory too: thread (row slot
// rs, column quad cq) takes rows rs, rs + RS, ... and columns 4 cq ..
// 4 cq + 3, one fmaf chain from 0 per output in k order 0 .. H-1, then the
// bias added where given.  KN's s = h W2 + b2 and KNB's dh = ds W2^T.
template <int H, bool kBwd>
__device__ __forceinline__ void row_product(const Smem<H, kBwd>& sm, int src, const float* w,
                                            int dst, const float* bias) {
  constexpr int CQ = H / 4, RS = kThreads / CQ;
  constexpr int NR = kRows / RS > 0 ? kRows / RS : 1;
  const int cq = threadIdx.x % CQ, rs = threadIdx.x / CQ;
  if (rs >= kRows) return;
  float acc[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 4) {
    float hv[NR][4];
#pragma unroll
    for (int i = 0; i < NR; ++i) unpack(ld4(sm.row(src, rs + i * RS) + k0), hv[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float wv[4];
      unpack(ld4(w + (k0 + kk) * H + 4 * cq), wv);
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_(hv[i][kk], wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = add(acc[i][j], bias[4 * cq + j]);
    }
    st4(sm.row(dst, rs + i * RS) + 4 * cq, acc[i]);
  }
}

// Steps 1-3 above for the tile of vertices v0 ..: h rows into buffer 0, s
// rows into buffer 1, each row's LN1 and LN2 statistics.  Ends on a block
// barrier.
template <int H, bool kBwd>
__device__ __forceinline__ void recompute_tile(const Smem<H, kBwd>& sm, const float* __restrict__ a,
                                               const float* __restrict__ b, long long v0, int D) {
  using L = Layout<H, kBwd>;
  constexpr int G = H / 4;
  const int tid = threadIdx.x;
  // 1. LN1, a row to a group of G lanes
  {
    const int c0 = 4 * (tid % G);
    for (int r = tid / G; r < kRows; r += L::kSlots) {
      const long long br = sm.brow()[r];
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (br >= 0) {
        float av[4], bv[4];
        unpack(ld4(a + (v0 + r / D) * H + c0), av);
        unpack(ld4(b + br * H + c0), bv);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = fmaxf(add(av[j], bv[j]), 0.f);
      }
      float mu, inv, h[4];
      ln_stats<H>(x, mu, inv);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = ln_affine(x[j], mu, inv, sm.g1()[c0 + j], sm.be1()[c0 + j]);
      st4(sm.row(0, r) + c0, h);
      if (tid % G == 0) {
        sm.mu1()[r] = mu;
        sm.inv1()[r] = inv;
      }
    }
  }
  __syncthreads();
  // 2. s = h W2 + b2
  row_product(sm, 0, sm.w2(), 1, sm.b2());
  __syncthreads();
  // 3. LN2's statistics of t = relu(s)
  {
    const int c0 = 4 * (tid % G);
    for (int r = tid / G; r < kRows; r += L::kSlots) {
      float t[4], mu, inv;
      unpack(ld4(sm.row(1, r) + c0), t);
#pragma unroll
      for (int j = 0; j < 4; ++j) t[j] = fmaxf(t[j], 0.f);
      ln_stats<H>(t, mu, inv);
      if (tid % G == 0) {
        sm.mu2()[r] = mu;
        sm.inv2()[r] = inv;
      }
    }
  }
  __syncthreads();
}

// Edge row r's outputs y = LN2(relu(s)) at channels c0 .. c0 + 3.
template <int H, bool kBwd>
__device__ __forceinline__ void row_out(const Smem<H, kBwd>& sm, int r, int c0, float (&y)[4]) {
  float s[4];
  unpack(ld4(sm.row(1, r) + c0), s);
  const float mu = sm.mu2()[r], inv = sm.inv2()[r];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = ln_affine(fmaxf(s[j], 0.f), mu, inv, sm.g2()[c0 + j], sm.be2()[c0 + j]);
}

template <int H>
__global__ void __launch_bounds__(kThreads, 4) narrow_edge_fwd_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const long long* __restrict__ nbr,
    const unsigned char* __restrict__ mask, const float* __restrict__ w2,
    const float* __restrict__ vecs, float* __restrict__ out, long long BV, int V, int D) {
  extern __shared__ __align__(16) float smem_f[];
  const Smem<H, false> sm{smem_f};
  constexpr int CQ = H / 4;
  const int tv = kRows / D;
  const long long n_tiles = (BV + tv - 1) / tv;
  stage_params<H, false>(sm, w2, vecs);
  __syncthreads();
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long v0 = t * tv;
    const int nv = static_cast<int>(BV - v0 < tv ? BV - v0 : tv);
    const bool live = tile_rows<H, false>(sm, nbr, mask, v0, nv, D, V);
    if (live) recompute_tile<H, false>(sm, a, b, v0, D);
    for (int it = threadIdx.x; it < nv * CQ; it += kThreads) {
      const int vl = it / CQ, c0 = 4 * (it % CQ);
      float best[4] = {kNeg, kNeg, kNeg, kNeg};
      bool any = false;
      for (int d = 0; d < D && live; ++d) {
        const int r = vl * D + d;
        if (sm.brow()[r] < 0) continue;
        any = true;
        float y[4];
        row_out<H, false>(sm, r, c0, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) best[j] = fmaxf(best[j], y[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) best[j] = any ? best[j] : 0.f;
      st4(out + (v0 + vl) * H + c0, best);
    }
    __syncthreads();   // the next tile rewrites the row table and the buffers
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads, 2) narrow_edge_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const long long* __restrict__ nbr,
    const unsigned char* __restrict__ mask, const float* __restrict__ w2,
    const float* __restrict__ vecs, const float* __restrict__ dout, float* __restrict__ da,
    float* __restrict__ dxe, float* __restrict__ part, float* __restrict__ ymax, long long BV,
    int V, int D) {
  extern __shared__ __align__(16) float smem_f[];
  using L = Layout<H, true>;
  const Smem<H, true> sm{smem_f};
  constexpr int G = H / 4, CQ = H / 4;
  // dW2's 4 x 4 tiles: NT of them, each summed over the rows by P threads
  // (rows p, p + P, ...), the P partials added in p order at the end
  constexpr int NT = CQ * CQ, P = kThreads / NT;
  const int tid = threadIdx.x;
  const int c0 = 4 * (tid % G);                        // the row phases' channels
  const int wt = tid % NT, wp = tid / NT;              // dW2 tile, row part
  const int wi = 4 * (wt / CQ), wo = 4 * (wt % CQ);    // its rows (W2's inputs) and columns
  const int tv = kRows / D;
  const long long n_tiles = (BV + tv - 1) / tv;
  float acc_w[4][4], acc_v[5][4];   // dW2 tile; dg1, dbe1, db2, dg2, dbe2 at c0 ..
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_w[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 5; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_v[i][j] = 0.f;
  stage_params<H, true>(sm, w2, vecs);
  __syncthreads();
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long v0 = t * tv;
    const int nv = static_cast<int>(BV - v0 < tv ? BV - v0 : tv);
    if (!tile_rows<H, true>(sm, nbr, mask, v0, nv, D, V)) {
      for (int i = tid; i < nv * H; i += kThreads) {
        da[v0 * H + i] = 0.f;
        if (ymax != nullptr) ymax[v0 * H + i] = 0.f;
      }
      __syncthreads();
      continue;
    }
    recompute_tile<H, true>(sm, a, b, v0, D);
    // 4. the max backward: dy into buffer 2
    for (int it = tid; it < nv * CQ; it += kThreads) {
      const int vl = it / CQ, cc = 4 * (it % CQ);
      float best[4] = {kNeg, kNeg, kNeg, kNeg}, cnt[4] = {0.f, 0.f, 0.f, 0.f}, y[4];
      bool any = false;
      for (int d = 0; d < D; ++d) {
        const int r = vl * D + d;
        if (sm.brow()[r] < 0) continue;
        any = true;
        row_out<H, true>(sm, r, cc, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (y[j] > best[j]) {
            best[j] = y[j];
            cnt[j] = 1.f;
          } else if (y[j] == best[j]) {
            cnt[j] = add(cnt[j], 1.f);
          }
        }
      }
      float share[4];
      unpack(ld4(dout + (v0 + vl) * H + cc), share);
#pragma unroll
      for (int j = 0; j < 4; ++j) share[j] = any ? __fdiv_rn(share[j], fmaxf(cnt[j], 1.f)) : 0.f;
      if (ymax != nullptr) {
        float y0[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) y0[j] = any ? best[j] : 0.f;
        st4(ymax + (v0 + vl) * H + cc, y0);
      }
      for (int d = 0; d < D; ++d) {
        const int r = vl * D + d;
        if (sm.brow()[r] < 0) continue;
        float dy[4];
        row_out<H, true>(sm, r, cc, y);
#pragma unroll
        for (int j = 0; j < 4; ++j) dy[j] = y[j] == best[j] ? share[j] : 0.f;
        st4(sm.row(2, r) + cc, dy);
      }
    }
    __syncthreads();
    // 5. LN2 backward: ds over s in buffer 1
    for (int r = tid / G; r < kRows; r += L::kSlots) {
      const bool ok = sm.brow()[r] >= 0;
      float s[4], dy[4] = {0.f, 0.f, 0.f, 0.f}, xn[4], dxn[4];
      unpack(ld4(sm.row(1, r) + c0), s);
      if (ok) unpack(ld4(sm.row(2, r) + c0), dy);
      const float mu = sm.mu2()[r], inv = sm.inv2()[r];
      float p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xn[j] = ln_xn(fmaxf(s[j], 0.f), mu, inv);
        dxn[j] = mul(dy[j], sm.g2()[c0 + j]);
        p1 = add(p1, dxn[j]);
        p2 = fma_(dxn[j], xn[j], p2);
      }
      const float m1 = mul(group_sum<G>(p1), 1.f / H), m2 = mul(group_sum<G>(p2), 1.f / H);
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dt = mul(sub(sub(dxn[j], m1), mul(xn[j], m2)), inv);
        ds[j] = ok ? mul(dt, relu_grad(s[j])) : 0.f;
        if (ok) {
          acc_v[2][j] = add(acc_v[2][j], ds[j]);
          acc_v[3][j] = fma_(dy[j], xn[j], acc_v[3][j]);
          acc_v[4][j] = add(acc_v[4][j], dy[j]);
        }
      }
      st4(sm.row(1, r) + c0, ds);
    }
    __syncthreads();
    // 6. dh = ds W2^T into buffer 2 (dy is spent), and the tile's h^T ds
    {
      row_product(sm, 1, sm.w2t(), 2, nullptr);
      for (int r = wp; r < kRows; r += P) {
        if (sm.brow()[r] < 0) continue;
        float hv[4], dv[4];
        unpack(ld4(sm.row(0, r) + wi), hv);
        unpack(ld4(sm.row(1, r) + wo), dv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_w[i][j] = fma_(hv[i], dv[j], acc_w[i][j]);
      }
    }
    __syncthreads();
    // 7. LN1 backward: dx over dh in buffer 2 and to the edge's row of dxe
    for (int r = tid / G; r < kRows; r += L::kSlots) {
      const long long br = sm.brow()[r];
      float x[4] = {0.f, 0.f, 0.f, 0.f}, dh[4], xn[4], dxn[4];
      if (br >= 0) {
        float av[4], bv[4];
        unpack(ld4(a + (v0 + r / D) * H + c0), av);
        unpack(ld4(b + br * H + c0), bv);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = add(av[j], bv[j]);
      }
      unpack(ld4(sm.row(2, r) + c0), dh);
      const float mu = sm.mu1()[r], inv = sm.inv1()[r];
      float p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xn[j] = ln_xn(fmaxf(x[j], 0.f), mu, inv);
        dxn[j] = mul(dh[j], sm.g1()[c0 + j]);
        p1 = add(p1, dxn[j]);
        p2 = fma_(dxn[j], xn[j], p2);
      }
      const float m1 = mul(group_sum<G>(p1), 1.f / H), m2 = mul(group_sum<G>(p2), 1.f / H);
      float dx[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dr = mul(sub(sub(dxn[j], m1), mul(xn[j], m2)), inv);
        dx[j] = br >= 0 ? mul(dr, relu_grad(x[j])) : 0.f;
        if (br >= 0) {
          acc_v[0][j] = fma_(dh[j], xn[j], acc_v[0][j]);
          acc_v[1][j] = add(acc_v[1][j], dh[j]);
        }
      }
      st4(sm.row(2, r) + c0, dx);
      if (br >= 0) st4(dxe + (v0 * D + r) * H + c0, dx);
    }
    __syncthreads();
    // 8. da[v]: the sum of v's valid dx rows, d in order
    for (int it = tid; it < nv * CQ; it += kThreads) {
      const int vl = it / CQ, cc = 4 * (it % CQ);
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dx[4];
      for (int d = 0; d < D; ++d) {
        const int r = vl * D + d;
        if (sm.brow()[r] < 0) continue;
        unpack(ld4(sm.row(2, r) + cc), dx);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = add(s[j], dx[j]);
      }
      st4(da + (v0 + vl) * H + cc, s);
    }
    __syncthreads();
  }
  // the block's partial, row blockIdx.x of part (H*H + 5H): dW2's P row
  // parts added in p order, then each vector's row slots in slot order
  float* red = sm.reduce();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(wp * H + wi + i) * H + wo + j] = acc_w[i][j];
  __syncthreads();
  float* mine = part + static_cast<long long>(blockIdx.x) * (H * H + 5 * H);
  for (int e = tid; e < H * H; e += kThreads) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s = add(s, red[p * H * H + e]);
    mine[e] = s;
  }
  __syncthreads();
  const int slot = tid / G;
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[slot * 5 * H + k * H + c0 + j] = acc_v[k][j];
  __syncthreads();
  for (int e = tid; e < 5 * H; e += kThreads) {
    float s = 0.f;
    for (int p = 0; p < L::kSlots; ++p) s = add(s, red[p * 5 * H + e]);
    mine[H * H + e] = s;
  }
}

// out[e] = the sum over the blocks' partials p = 0 .. n_parts - 1 in order of
// part[p, e]: a thread per element.
__global__ void __launch_bounds__(256) narrow_fold_kernel(const float* __restrict__ part,
                                                          float* __restrict__ out, int n_parts,
                                                          int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s = __fadd_rn(s, part[static_cast<long long>(p) * n + e]);
  out[e] = s;
}

// Sets a kernel's dynamic shared memory once per process.
template <class Kernel>
cudaError_t set_smem(Kernel kern, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  done = err == cudaSuccess;
  return err;
}

long long tiles(int B, int V, int D) {
  return (static_cast<long long>(B) * V + kRows / D - 1) / (kRows / D);
}

int bwd_grid(int B, int V, int D) {
  const long long n = tiles(B, V, D);
  return static_cast<int>(n < kBwdBlocks ? (n > 0 ? n : 1) : kBwdBlocks);
}

template <int H>
cudaError_t launch_fwd(const void* a, const void* b, const void* nbr, const void* mask,
                       const void* w2, const void* vecs, void* out, int B, int V, int D,
                       cudaStream_t s) {
  using L = Layout<H, false>;
  static bool ready = false;
  cudaError_t err = set_smem(narrow_edge_fwd_kernel<H>, L::kBytes, ready);
  if (err != cudaSuccess) return err;
  const long long n = tiles(B, V, D);
  if (n == 0) return cudaSuccess;
  const int grid = static_cast<int>(n < kFwdBlocks ? n : kFwdBlocks);
  narrow_edge_fwd_kernel<H><<<grid, kThreads, L::kBytes, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const long long*>(nbr), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(w2), static_cast<const float*>(vecs), static_cast<float*>(out),
      static_cast<long long>(B) * V, V, D);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bwd(const void* a, const void* b, const void* nbr, const void* mask,
                       const void* w2, const void* vecs, const void* dout, void* da, void* dxe,
                       void* part, void* sums, void* ymax, int B, int V, int D, int grid,
                       cudaStream_t s) {
  using L = Layout<H, true>;
  static bool ready = false;
  cudaError_t err = set_smem(narrow_edge_bwd_kernel<H>, L::kBytes, ready);
  if (err != cudaSuccess) return err;
  if (grid != bwd_grid(B, V, D)) return cudaErrorInvalidValue;   // partials sized for another grid
  narrow_edge_bwd_kernel<H><<<grid, kThreads, L::kBytes, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const long long*>(nbr), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(w2), static_cast<const float*>(vecs),
      static_cast<const float*>(dout), static_cast<float*>(da), static_cast<float*>(dxe),
      static_cast<float*>(part), static_cast<float*>(ymax), static_cast<long long>(B) * V, V, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * H + 5 * H;
  narrow_fold_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                     static_cast<float*>(sums), grid, n);
  return cudaGetLastError();
}

}  // namespace

#define MORIG_NARROW_WIDTHS(CALL)                            \
  switch (H) {                                               \
    case 8: return static_cast<int>(CALL(8));                \
    case 16: return static_cast<int>(CALL(16));              \
    case 32: return static_cast<int>(CALL(32));              \
    case 64: return static_cast<int>(CALL(64));              \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// KN.  a, b (B,V,H) fp32, 16-byte aligned; nbr (B,V,D) int64 in [0, V);
// mask (B,V,D) bool; w2 (H,H) fp32 (input channel major); vecs (5H fp32: g1
// | be1 | b2 | g2 | be2).  Writes out (B,V,H) fp32.  H in {8, 16, 32, 64},
// 1 <= D <= 16.  Returns cudaGetLastError() after the launch.
extern "C" int narrow_edge_forward(const void* a, const void* b, const void* nbr,
                                   const void* mask, const void* w2, const void* vecs, void* out,
                                   int B, int V, int D, int H, void* stream) {
  if (D < 1 || D > 16 || B < 0 || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MORIG_FWD(W) launch_fwd<W>(a, b, nbr, mask, w2, vecs, out, B, V, D, s)
  MORIG_NARROW_WIDTHS(MORIG_FWD)
#undef MORIG_FWD
}

// KNB's grid for these shapes: its partials are (grid, H*H + 5H) fp32.
extern "C" int narrow_edge_backward_grid(int B, int V, int D, int* grid) {
  if (D < 1 || D > 16 || B < 0 || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  *grid = bwd_grid(B, V, D);
  return 0;
}

// KNB.  KN's arguments and dout (B,V,H) fp32.  Writes da (B,V,H) fp32, each
// valid edge's dx row to dxe (B*V*D, H) fp32 (the caller sums them into
// db_table with the ordered row scatter; masked edges' rows are left
// unwritten), sums (H*H + 5H fp32: dW2 | dg1 | dbe1 | db2 | dg2 | dbe2) through
// part (grid, H*H + 5H), and where ymax is not null the recomputed forward
// (B,V,H) fp32.  `grid` from narrow_edge_backward_grid.  Returns the first
// cudaGetLastError() of its two launches.
extern "C" int narrow_edge_backward(const void* a, const void* b, const void* nbr,
                                    const void* mask, const void* w2, const void* vecs,
                                    const void* dout, void* da, void* dxe, void* part, void* sums,
                                    void* ymax, int B, int V, int D, int H, int grid,
                                    void* stream) {
  if (D < 1 || D > 16 || B < 0 || V < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MORIG_BWD(W) \
  launch_bwd<W>(a, b, nbr, mask, w2, vecs, dout, da, dxe, part, sums, ymax, B, V, D, grid, s)
  MORIG_NARROW_WIDTHS(MORIG_BWD)
#undef MORIG_BWD
}

#undef MORIG_NARROW_WIDTHS
