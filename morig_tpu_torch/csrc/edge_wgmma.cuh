// The fused EdgeMLP tail's step code on Hopper's warpgroup product, used by
// K1 (edge_mlp.cu `edge_mlp_table_kernel`, the forward of serving and of
// training), K5 (`edge_mlp_windowed_kernel`) and K6's recompute
// (edge_mlp_bwd.cu).  K6 routes its max by exact equality against K1's
// outputs, so both run `slab_product` and `ln2_stats` below on each row with
// the same parity, k order and column split, and every LayerNorm expression
// is written with explicitly rounded intrinsics, so that no inlining context
// contracts it differently.
//
// A work unit is 64 vertices of one vertex tile; it runs degree-major, one
// 64-row "slab" per neighbour slot d: row r of slab d is edge d of vertex
// v0 + r.  Per slab a warpgroup (128 threads, 4 warps) computes
//
//   h     = bf16(LN1(relu(a[v] + b[nbr[v,d]])))       into wgmma's A registers
//   acc   = h @ W2                                      wgmma m64nNk16, fp32 sums
//   best  = max(best, LN2(relu(acc + b2)))              for the valid edges
//
// where thread (warp w, lane l) holds rows r = 16w + l/4 and r + 8 of both
// the A operand and the accumulator, so LN1, LN2 and the masked max need no
// shared memory: a row's statistics are summed over the 4 lanes of a quad
// (and, where two warpgroups split the columns, with the other warpgroup's
// through a 64-row exchange).  LayerNorms are fp32 with var = max(E[x^2] -
// E[x]^2, 0), eps 1e-6, over the true width.  A slab in which no vertex of
// the unit has a valid edge is skipped, and so is every slab of a unit
// without one (its rows are 0).  Where two warpgroups share a unit's rows
// and split its output columns (kSplit, H = 256: 128 accumulators and 128
// running maxima per thread would not fit in registers), each builds LN1
// for half of the k-chunks and the two trade their fragments through
// shared memory, so no LN1 value is computed twice.
//
// The k order.  Lane l (q = l % 4) holds, of each row, H/4 columns in
// pieces of P = 8 (P = 4 at H = 16): piece p is columns (4p + q) P ..
// (4p + q) P + P - 1, so the quad reads 4P contiguous columns per load; it
// fills k-chunks c = p P/4 + e/4 (e the column's place in the piece).
// wgmma wants k = 16c + 2q + {0, 1, 8, 9} of chunk c in that thread's
// registers, so column (4 (c / (P/4)) + q) P + 4 (c % (P/4)) + j sits at
// physical k = 16c + 2q + (j & 1) + 8 (j >> 1), and W2's rows are laid out
// in the same physical order by the wrapper (kernels/edge_fused.py
// `wgmma_k_order`, `wgmma_w2_layout`): the product over k is the same sum
// in another order.  W2 arrives in
// wgmma's interleaved K-major layout: core matrices of 8 output columns x 8
// k (128 contiguous bytes), N/8 of them per group of 8 k, the groups in k
// order; one bulk copy (the TMA engine) stages it in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace morig_wg {

constexpr int kUnit = 64;          // vertices per work unit: the product's M
constexpr int kWgThreads = 128;    // one warpgroup
constexpr int kThreads = 256;      // two warpgroups per block
constexpr float kEps = 1e-6f;
constexpr float kNeg = -1e30f;
// codes[d * 64 + r] of a unit: the window row of a valid edge inside the
// window (>= 0), or one of these.
constexpr int kOutside = -1;       // a valid edge whose neighbour is outside the window
constexpr int kInvalid = -2;       // a masked edge, or a row past the tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to the async proxy
// (wgmma, bulk copies).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory with the TMA engine; the barrier's phase
// completes when they have arrived.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  fence_async_shared();
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 128 threads of warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// P (4 or 8) bf16 values from an 8- or 16-byte aligned address, as fp32.
template <int P>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&x)[P]) {
  static_assert(P == 4 || P == 8, "pieces of 4 or 8");
  if constexpr (P == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A LayerNorm's statistics over H values (a power of two, so that a product
// with 1 / H is the quotient by H exactly) from their sum s and sum of
// squares s2: mu, and inv = rsqrt(max(E[x^2] - mu^2, 0) + eps).
template <int H>
__device__ __forceinline__ void ln_mu_inv(float s, float s2, float& mu, float& inv) {
  static_assert((H & (H - 1)) == 0, "a power-of-two width");
  constexpr float kInvH = 1.f / H;
  mu = __fmul_rn(s, kInvH);
  inv = rsqrtf(__fadd_rn(fmaxf(__fmaf_rn(-mu, mu, __fmul_rn(s2, kInvH)), 0.f), kEps));
}

// (x - mu) * inv, and its affine output xn * g + be.
__device__ __forceinline__ float ln_xn(float x, float mu, float inv) {
  return __fmul_rn(__fsub_rn(x, mu), inv);
}
__device__ __forceinline__ float ln_affine(float x, float mu, float inv, float g, float be) {
  return __fmaf_rn(ln_xn(x, mu, inv), g, be);
}

// The descriptor of W2's B operand for k-chunk c (16 k) and output columns
// n0.. (n0 a multiple of 8): leading (k) stride 16 H bytes between the two
// 8-k groups, stride 128 bytes between 8-column core matrices, no swizzle.
template <int H>
__device__ __forceinline__ uint64_t w2_desc(const __nv_bfloat16* w2s, int c, int n0) {
  const uint32_t addr = smem_u32(w2s) + static_cast<uint32_t>(c * 32 * H + n0 * 16);
  constexpr uint64_t kLead = (16 * H) >> 4, kStride = 128 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kLead << 16) | (kStride << 32);
}

// Shared-memory vectors of a layer: g1, be1 (LN1), b2, g2, be2 (LN2), H each.
template <int H>
struct Vecs {
  const float* v;
  __device__ __forceinline__ const float* g1() const { return v; }
  __device__ __forceinline__ const float* be1() const { return v + H; }
  __device__ __forceinline__ const float* b2() const { return v + 2 * H; }
  __device__ __forceinline__ const float* g2() const { return v + 3 * H; }
  __device__ __forceinline__ const float* be2() const { return v + 4 * H; }
};

template <int H>
__device__ __forceinline__ void stage_vecs(float* dst, const float* g1, const float* be1,
                                           const float* b2, const float* g2, const float* be2) {
  for (int k = threadIdx.x; k < 5 * H; k += blockDim.x) {
    const int which = k / H, c = k % H;
    const float* src = which == 0 ? g1 : which == 1 ? be1 : which == 2 ? b2 : which == 3 ? g2 : be2;
    dst[k] = src[c];
  }
}

// codes[d * 64 + r] for the unit's rows r < 64 (vertices row_base + r of the
// flattened (B*V) table, r < nv) over its D slots, for a window of wlen rows
// from ws; nthreads (128 or 256) threads from tid.  The unit's nv * D table
// entries are contiguous: consecutive threads read consecutive entries, up
// to 8 each, with all loads in flight together.  Each warp's lane 0 writes
// the OR of its entries' live slots (bit d: some edge d is valid) to
// livew[warp].
__device__ __forceinline__ void unit_codes(int* codes, uint32_t* livew, int nthreads, int tid,
                                           const long long* __restrict__ nbr,
                                           const unsigned char* __restrict__ mask,
                                           long long row_base, int nv, int D, int ws, int wlen) {
  constexpr int kMaxEntries = 16 * kUnit / kWgThreads;
  const long long* tn = nbr + row_base * D;
  const unsigned char* tm = mask + row_base * D;
  const int n = nv * D;
  long long j[kMaxEntries];
  bool m[kMaxEntries];
#pragma unroll
  for (int k = 0; k < kMaxEntries; ++k) {
    const int e = tid + k * nthreads;
    j[k] = e < n ? tn[e] : 0;
    m[k] = e < n && tm[e];
  }
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kMaxEntries; ++k) {
    const int e = tid + k * nthreads;
    if (e >= D * kUnit) break;
    const long long w = j[k] - ws;
    const int code = !m[k] ? kInvalid : w >= 0 && w < wlen ? static_cast<int>(w) : kOutside;
    const int r = e / D, d = e - r * D;
    codes[d * kUnit + r] = code;
    if (code != kInvalid) bits |= 1u << d;
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if (tid % 32 == 0) livew[tid / 32] = bits;
}

// relu(a + b) of P columns (b nullptr: a zero row).
template <int P>
__device__ __forceinline__ void relu_sum(const __nv_bfloat16* __restrict__ ar,
                                         const __nv_bfloat16* br, float (&t)[P]) {
  float x[P], y[P];
  load_bf16<P>(ar, x);
  if (br != nullptr) {
    load_bf16<P>(br, y);
  } else {
#pragma unroll
    for (int e = 0; e < P; ++e) y[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < P; ++e) t[e] = fmaxf(__fadd_rn(x[e], y[e]), 0.f);
}

// The A operand of one slab for this thread's two rows (`lo` = row r, `hi` =
// row r + 8): bf16(LN1(relu(a + b))) of its columns in the k order above,
// or zeros for an invalid row; here of NPX pieces from piece p0 (all of the
// row's, or one warpgroup's half), into the fragments of k-chunks p0 P/4 ...
// a*: the vertex's row of a (read only when valid); b*: the neighbour's row
// of b, or nullptr for a zero row.  Two passes over the row (statistics,
// then values) keep only the fragments in registers; with `stat` ([2][64]
// float2, under one block barrier) each row's statistics are summed with
// the other warpgroup's half; mu and inv get each row's statistics.  Lane
// q's piece p is columns (4p + q) P .. (P = 8, or 4 at H=16), so a quad
// reads 4P contiguous values of a row per load; where a row's parity (sw_lo,
// sw_hi: the parity of its vertex, r & 1 in K1 and K5) is odd, its quad
// takes the two pieces of each pair in swapped order, so the warp's 8 rows
// fall on both halves of the shared-memory banks.  The parity fixes the
// order of the row's sums, so K6 passes each row's own.
template <int H, int NPX>
__device__ __forceinline__ void ln1_pieces(const __nv_bfloat16* __restrict__ a_lo,
                                           const __nv_bfloat16* b_lo, bool ok_lo,
                                           const __nv_bfloat16* __restrict__ a_hi,
                                           const __nv_bfloat16* b_hi, bool ok_hi,
                                           const Vecs<H>& vec, int q, int sw_lo, int sw_hi,
                                           int p0, float2* stat, int g, int r,
                                           uint32_t (&afr)[NPX * (H < 32 ? 1 : 2)][4],
                                           float (&mu)[2], float (&inv)[2]) {
  constexpr int P = H < 32 ? 4 : 8;    // columns per piece (one load)
  constexpr int CP = P / 4;            // k-chunks per piece
  static_assert(NPX == 1 || NPX % 2 == 0, "pieces pair up");
  const __nv_bfloat16* ar[2] = {a_lo, a_hi};
  const __nv_bfloat16* br[2] = {b_lo, b_hi};
  const bool ok[2] = {ok_lo, ok_hi};
  const int sw[2] = {sw_lo, sw_hi};
  auto piece_col = [&](int p, int h) {
    return (4 * (p0 + (NPX > 1 ? p ^ sw[h] : p)) + q) * P;
  };

  float s[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < NPX; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      const int col = piece_col(p, h);
      float t[P];
      relu_sum<P>(ar[h] + col, br[h] != nullptr ? br[h] + col : nullptr, t);
#pragma unroll
      for (int e = 0; e < P; ++e) {
        s[h] = __fadd_rn(s[h], t[e]);
        s2[h] = __fmaf_rn(t[e], t[e], s2[h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] = quad_sum(s[h]);
    s2[h] = quad_sum(s2[h]);
  }
  if (stat != nullptr) {
    if (q == 0) {
      stat[g * kUnit + r] = make_float2(s[0], s2[0]);
      stat[g * kUnit + r + 8] = make_float2(s[1], s2[1]);
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 o = stat[(1 - g) * kUnit + r + 8 * h];
      s[h] = __fadd_rn(s[h], o.x);
      s2[h] = __fadd_rn(s2[h], o.y);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) ln_mu_inv<H>(s[h], s2[h], mu[h], inv[h]);
  // pass 2: each row's normalised values of the piece at p's load (piece
  // p ^ sw where pieces pair up), packed as fragments
  auto pack_piece = [&](int p, uint32_t (&pk)[CP][4]) {
    float hv[2][P];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) {
#pragma unroll
        for (int e = 0; e < P; ++e) hv[h][e] = 0.f;
        continue;
      }
      const int col = piece_col(p, h);
      float t[P];
      relu_sum<P>(ar[h] + col, br[h] != nullptr ? br[h] + col : nullptr, t);
#pragma unroll
      for (int e4 = 0; e4 < P / 4; ++e4) {
        const float4 g1 = *reinterpret_cast<const float4*>(vec.g1() + col + 4 * e4);
        const float4 be = *reinterpret_cast<const float4*>(vec.be1() + col + 4 * e4);
        const float* t4 = t + 4 * e4;
        hv[h][4 * e4] = ln_affine(t4[0], mu[h], inv[h], g1.x, be.x);
        hv[h][4 * e4 + 1] = ln_affine(t4[1], mu[h], inv[h], g1.y, be.y);
        hv[h][4 * e4 + 2] = ln_affine(t4[2], mu[h], inv[h], g1.z, be.z);
        hv[h][4 * e4 + 3] = ln_affine(t4[3], mu[h], inv[h], g1.w, be.w);
      }
    }
#pragma unroll
    for (int cc = 0; cc < CP; ++cc) {
      pk[cc][0] = pack_bf16(hv[0][4 * cc], hv[0][4 * cc + 1]);
      pk[cc][1] = pack_bf16(hv[1][4 * cc], hv[1][4 * cc + 1]);
      pk[cc][2] = pack_bf16(hv[0][4 * cc + 2], hv[0][4 * cc + 3]);
      pk[cc][3] = pack_bf16(hv[1][4 * cc + 2], hv[1][4 * cc + 3]);
    }
  };
  if constexpr (NPX == 1) {
    uint32_t pk[CP][4];
    pack_piece(0, pk);
#pragma unroll
    for (int cc = 0; cc < CP; ++cc)
#pragma unroll
      for (int k = 0; k < 4; ++k) afr[cc][k] = pk[cc][k];
  } else {
#pragma unroll
    for (int m = 0; m < NPX / 2; ++m) {
      uint32_t pa[CP][4], pb[CP][4];
      pack_piece(2 * m, pa);
      pack_piece(2 * m + 1, pb);
#pragma unroll
      for (int cc = 0; cc < CP; ++cc)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int swk = k & 1 ? sw_hi : sw_lo;     // registers 0, 2: row lo; 1, 3: row hi
          afr[2 * m * CP + cc][k] = swk ? pb[cc][k] : pa[cc][k];
          afr[(2 * m + 1) * CP + cc][k] = swk ? pa[cc][k] : pb[cc][k];
        }
    }
  }
}

// LN2's statistics of one slab's accumulators (this warpgroup's NW columns
// from n0): acc becomes t = relu(acc + b2) in place, and mu, inv get the
// statistics of the thread's rows r (lo) and r + 8 (hi).  With kSplit the
// two warpgroups of the block hold the two column halves of the same rows,
// and each row's statistics are the sum of both halves', exchanged through
// red ([2][64] float2) under one block barrier.  K1 and K6 both call this,
// then `ln_affine(t, mu, inv, g2, be2)` per element: the output bits K6's
// route compares.
template <int H, int NW, bool kSplit>
__device__ __forceinline__ void ln2_stats(float (&acc)[NW / 2], const Vecs<H>& vec, int n0, int q,
                                          int r, int wg, float2* red, float (&mu)[2],
                                          float (&inv)[2]) {
  const float* b2 = vec.b2() + n0 + 2 * q;
  float s_lo = 0.f, s2_lo = 0.f, s_hi = 0.f, s2_hi = 0.f;
#pragma unroll
  for (int i = 0; i < NW / 8; ++i) {
    const float2 bb = *reinterpret_cast<const float2*>(b2 + 8 * i);
    acc[4 * i] = fmaxf(__fadd_rn(acc[4 * i], bb.x), 0.f);
    acc[4 * i + 1] = fmaxf(__fadd_rn(acc[4 * i + 1], bb.y), 0.f);
    acc[4 * i + 2] = fmaxf(__fadd_rn(acc[4 * i + 2], bb.x), 0.f);
    acc[4 * i + 3] = fmaxf(__fadd_rn(acc[4 * i + 3], bb.y), 0.f);
    s_lo = __fadd_rn(s_lo, __fadd_rn(acc[4 * i], acc[4 * i + 1]));
    s2_lo = __fmaf_rn(acc[4 * i], acc[4 * i], __fmaf_rn(acc[4 * i + 1], acc[4 * i + 1], s2_lo));
    s_hi = __fadd_rn(s_hi, __fadd_rn(acc[4 * i + 2], acc[4 * i + 3]));
    s2_hi = __fmaf_rn(acc[4 * i + 2], acc[4 * i + 2],
                      __fmaf_rn(acc[4 * i + 3], acc[4 * i + 3], s2_hi));
  }
  s_lo = quad_sum(s_lo);
  s2_lo = quad_sum(s2_lo);
  s_hi = quad_sum(s_hi);
  s2_hi = quad_sum(s2_hi);
  if constexpr (kSplit) {
    if (q == 0) {
      red[wg * kUnit + r] = make_float2(s_lo, s2_lo);
      red[wg * kUnit + r + 8] = make_float2(s_hi, s2_hi);
    }
    __syncthreads();
    const float2 o_lo = red[(1 - wg) * kUnit + r], o_hi = red[(1 - wg) * kUnit + r + 8];
    s_lo = __fadd_rn(s_lo, o_lo.x);
    s2_lo = __fadd_rn(s2_lo, o_lo.y);
    s_hi = __fadd_rn(s_hi, o_hi.x);
    s2_hi = __fadd_rn(s2_hi, o_hi.y);
  }
  ln_mu_inv<H>(s_lo, s2_lo, mu[0], inv[0]);
  ln_mu_inv<H>(s_hi, s2_hi, mu[1], inv[1]);
}

// LN2 of one slab's accumulators and the masked max into best.
template <int H, int NW, bool kSplit>
__device__ __forceinline__ void ln2_max(float (&acc)[NW / 2], float (&best)[NW / 2], bool ok_lo,
                                        bool ok_hi, const Vecs<H>& vec, int n0, int q, int r,
                                        int wg, float2* red) {
  float mu[2], inv[2];
  ln2_stats<H, NW, kSplit>(acc, vec, n0, q, r, wg, red, mu, inv);
  const float* g2 = vec.g2() + n0 + 2 * q;
  const float* be2 = vec.be2() + n0 + 2 * q;
#pragma unroll
  for (int i = 0; i < NW / 8; ++i) {
    const float2 g = *reinterpret_cast<const float2*>(g2 + 8 * i);
    const float2 be = *reinterpret_cast<const float2*>(be2 + 8 * i);
    if (ok_lo) {
      best[4 * i] = fmaxf(best[4 * i], ln_affine(acc[4 * i], mu[0], inv[0], g.x, be.x));
      best[4 * i + 1] = fmaxf(best[4 * i + 1], ln_affine(acc[4 * i + 1], mu[0], inv[0], g.y, be.y));
    }
    if (ok_hi) {
      best[4 * i + 2] = fmaxf(best[4 * i + 2], ln_affine(acc[4 * i + 2], mu[1], inv[1], g.x, be.x));
      best[4 * i + 3] = fmaxf(best[4 * i + 3], ln_affine(acc[4 * i + 3], mu[1], inv[1], g.y, be.y));
    }
  }
}

// One slab for this thread's rows: LN1 into A, the product over H/16
// k-chunks on this warpgroup's NW columns from n0, LN2 and the max.  With
// kSplit at H >= 64 the two warpgroups (which share the rows and split the
// columns) each build half of the k-chunks' fragments and trade them
// through xfr (H/32 uint4 per thread of the block, 128 H bytes: the slab's
// own ring stage, free once both halves of LN1 have read it); each then
// runs its own chunks first.  Below H=64 each builds all of them.  sw_lo,
// sw_hi: the rows' parities (`ln1_pieces`); mu1, inv1 get their LN1
// statistics; `frags(c, f)` is called, once the product is done, with the
// fragments f of each k-chunk c this warpgroup built.
template <int H, int NW, bool kSplit, class Frags>
__device__ __forceinline__ void slab_product(const __nv_bfloat16* a_lo, const __nv_bfloat16* b_lo,
                                             bool ok_lo, const __nv_bfloat16* a_hi,
                                             const __nv_bfloat16* b_hi, bool ok_hi, int sw_lo,
                                             int sw_hi, const __nv_bfloat16* w2s,
                                             const Vecs<H>& vec, int n0, int q, int r, int wg,
                                             float2* red, uint4* xfr, float (&acc)[NW / 2],
                                             float (&mu1)[2], float (&inv1)[2], Frags&& frags) {
  constexpr int KC = H / 16;           // k-chunks
  if constexpr (kSplit && H >= 64) {
    constexpr int HC = KC / 2;         // k-chunks of one warpgroup's half
    uint32_t own[HC][4], other[HC][4];
    ln1_pieces<H, H / 64>(a_lo, b_lo, ok_lo, a_hi, b_hi, ok_hi, vec, q, sw_lo, sw_hi,
                          wg * H / 64, red, wg, r, own, mu1, inv1);
    const int t = threadIdx.x % kWgThreads;
    __syncthreads();                   // both halves of LN1 are done with the ring stage
#pragma unroll
    for (int c = 0; c < HC; ++c)
      xfr[(wg * HC + c) * kWgThreads + t] = make_uint4(own[c][0], own[c][1], own[c][2], own[c][3]);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const uint4 v = xfr[((1 - wg) * HC + c) * kWgThreads + t];
      other[c][0] = v.x;
      other[c][1] = v.y;
      other[c][2] = v.z;
      other[c][3] = v.w;
    }
    wgmma_fence();
    fence_operands(acc);
    fence_operands(own);
    fence_operands(other);
#pragma unroll
    for (int c = 0; c < HC; ++c)
      Wgmma<NW>::mma(acc, own[c], w2_desc<H>(w2s, wg * HC + c, n0), c > 0);
#pragma unroll
    for (int c = 0; c < HC; ++c)
      Wgmma<NW>::mma(acc, other[c], w2_desc<H>(w2s, (1 - wg) * HC + c, n0), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    fence_operands(own);
    fence_operands(other);
#pragma unroll
    for (int c = 0; c < HC; ++c) frags(wg * HC + c, own[c]);
  } else {
    uint32_t afr[KC][4];
    ln1_pieces<H, H < 32 ? 1 : H / 32>(a_lo, b_lo, ok_lo, a_hi, b_hi, ok_hi, vec, q, sw_lo,
                                       sw_hi, 0, nullptr, wg, r, afr, mu1, inv1);
    wgmma_fence();
    fence_operands(acc);
    fence_operands(afr);
#pragma unroll
    for (int c = 0; c < KC; ++c) Wgmma<NW>::mma(acc, afr[c], w2_desc<H>(w2s, c, n0), c > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    fence_operands(afr);
#pragma unroll
    for (int c = 0; c < KC; ++c) frags(c, afr[c]);
  }
}

// One slab of K1 or K5: `slab_product` with the rows' parity r & 1, then
// LN2 and the max.
template <int H, int NW, bool kSplit>
__device__ __forceinline__ void slab(const __nv_bfloat16* a_lo, const __nv_bfloat16* b_lo,
                                     bool ok_lo, const __nv_bfloat16* a_hi,
                                     const __nv_bfloat16* b_hi, bool ok_hi,
                                     const __nv_bfloat16* w2s, const Vecs<H>& vec, int n0, int q,
                                     int r, int wg, float2* red, uint4* xfr,
                                     float (&acc)[NW / 2], float (&best)[NW / 2]) {
  float mu1[2], inv1[2];
  slab_product<H, NW, kSplit>(a_lo, b_lo, ok_lo, a_hi, b_hi, ok_hi, r & 1, r & 1, w2s, vec, n0, q,
                              r, wg, red, xfr, acc, mu1, inv1, [](int, const uint32_t (&)[4]) {});
  ln2_max<H, NW, kSplit>(acc, best, ok_lo, ok_hi, vec, n0, q, r, wg, red);
}

// This thread's outputs of a unit: rows r (out_lo) and r + 8 (out_hi), each
// nullptr past the tile; the max where the row has a valid edge, else 0.
template <int NW>
__device__ __forceinline__ void store_rows(float* out_lo, bool any_lo, float* out_hi, bool any_hi,
                                           const float (&best)[NW / 2], int n0, int q) {
#pragma unroll
  for (int i = 0; i < NW / 8; ++i) {
    const int col = n0 + 8 * i + 2 * q;
    if (out_lo != nullptr)
      *reinterpret_cast<float2*>(out_lo + col) =
          any_lo ? make_float2(best[4 * i], best[4 * i + 1]) : make_float2(0.f, 0.f);
    if (out_hi != nullptr)
      *reinterpret_cast<float2*>(out_hi + col) =
          any_hi ? make_float2(best[4 * i + 2], best[4 * i + 3]) : make_float2(0.f, 0.f);
  }
}

constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may have

// The persistent grid of one kernel instance of kThreads threads at one
// shared-memory size: its dynamic shared memory is set and its occupancy
// read once per size.
struct GridCache {
  size_t smem = 0;
  long long cap = 0;
};

template <class Kernel>
inline cudaError_t persistent_grid(Kernel kern, size_t smem, long long units, GridCache& cache,
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

}  // namespace morig_wg
