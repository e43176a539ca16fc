// K6 — one-pass backward of the fused EdgeMLP tail (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel morig_tpu/kernels/edge_fused.py `fused_edge_mlp_bwd`
// (:429; body `_bwd_kernel` :320-425).  It is the backward of every edge
// layer on the training path (nn/gcu.py EdgeMLP with train=True, through
// kernels/edge_fused.py `fused_edge_mlp_trainable`, whose forward is K1).
// Given the forward's inputs and dout = dL/dout (B,V,H2), it returns
//
//   da (B,V,H1), db_table (B,V,H1), dW2 (H1,H2), db2, dg1, dbe1, dg2, dbe2
//
// in fp32.  The forward is recomputed in the kernel with K1's own step code
// (edge_wgmma.cuh `slab_product`, `ln2_stats`, `ln_affine`), each edge row
// with its vertex's parity and K1's column split, so each recomputed
// per-edge output equals the one K1 gave the loss bit for bit; the max
// backward then routes dout to the valid edges that equal the max by exact
// equality, splitting ties equally (dout / count; 0 on rows with no valid
// edge).  Then, in fp32 per edge row: LN2 backward, relu, ds; dh =
// bf16(ds) @ bf16(W2)^T and dW2 = bf16(h)^T @ bf16(ds) on the tensor cores
// (fp32 sums); LN1 backward, relu -> dx; da[v] is the fp32 sum over v's edges
// of dx (d in order) and db_table[nbr] += bf16(dx), the TPU kernel's
// precision (`precise=False`).
//
// What does not carry over from the TPU: there the grid runs in order, so the
// db_table block and the dW2/vector sums stay resident across grid steps.
// Here blocks run in parallel: db_table is a scatter of fp32 atomics into a
// buffer the wrapper zeroes (the order of the adds varies from run to run, so
// db_table is not bitwise deterministic); the five vector sums are per-block
// partials and dW2 per-split partials of its own kernel, each added over the
// blocks in a fixed order by `sum_parts_kernel`, so they are deterministic
// for a given grid.
//
// Three kernels per call.
//
// `edge_mlp_bwd_kernel` walks 64-edge-row steps (the D edges of 64 / D
// vertices) over a persistent grid of 8-warp blocks.  A step none of whose
// edges is valid (mesh padding: about 37% of the training tables' steps)
// writes its da rows as 0 and its live flag as 0 and does nothing else, so
// the decision costs one block barrier (`__syncthreads_or` over the step's
// mask).  A live step: (1) recomputes its 64 rows as one slab of K1: LN1
// into wgmma's A registers from a and b in global memory, the product with
// W2 (staged once per block in K1's layout by one bulk copy) and LN2's
// statistics; at H = 256 the two warpgroups split the columns and trade LN1
// fragments and row sums as K1 does, below one warpgroup runs the slab on
// all H columns (a column split would change the order of LN2's sums) while
// the other waits; (2) writes h, the A fragments the product took, to the
// step's scratch tile, and t = relu(y + b2) rows (fp32) to ys with each
// row's LN2 mean and inverse deviation; (3) the max and LN2 backward, one
// vertex per warp, rebuild each output with `ln_affine` and write ds (bf16)
// into the ds area, laid out as the B operand of (4) dh^T = W2 ds^T, one
// `wgmma` m64nNk16 chain per 64 rows of W2 (A = W2 by `ldmatrix.trans` from
// K1's layout, so W2 is held once; dh rows come out in K1's k order and
// land in ys at their LN1 columns), while the block copies ds to the
// scratch tile; (5) the LN1 backward runs one edge row per warp over all 8
// warps, a lane holding H1/32 contiguous channels (a and b read 16 bytes at
// a time at H1 = 256), and writes dx over dh; (6) da[v] sums v's dx rows in
// d order.
//
// `edge_mlp_dw2_kernel` computes dW2 = sum over live steps of h^T ds from
// the scratch tiles: a block is one warpgroup on one 64-row slab of dW2's H1
// rows (H1 / 64 slabs, or one below 64) and one split of the steps (step t
// goes to split t mod S), its tiles through a three-stage cp.async ring; A
// (h^T, by ldmatrix) and B (ds, by descriptor) are both read from the
// no-swizzle K-major core-matrix layout the tile is written in: chunk (g, c)
// of a 64 x H part, at byte 16 (g H + c), holds rows 8g .. 8g + 7 of column
// c, so the 8 columns c = 8n .. 8n + 7 of row group g form one 128-byte core
// matrix.  Products are m64nNk16 with N = H2 up to 128 (two at H2 = 256).
// Each split writes its (H1, H2) partial; `sum_parts_kernel` adds the S
// partials.
//
// Shared memory of the main kernel: W2 resident (bf16, K1's layout, up to
// 128 KB at 256x256), the ds area (64 x H1 bf16; at H = 256 first the LN1
// fragment exchange), ys (64 x H2 fp32: t, then dh, then dx), the row-sum
// exchange and per-row LN1 and LN2 statistics; x and xn1 are recomputed
// from a, b and the kept statistics, and the layer's vectors are read
// through L1.  At H=256 that is 231,448 bytes: one block of 8 warps per SM.
//
// What bounds it on the H100: three products of 2*E*H1*H2 FLOPs each (the
// recompute, dh and dW2; E = the valid edge rows) against reading a, b, dout
// and writing da and db_table, so the tensor cores at every width.  What
// costs the time (PERF.md): the chain of barriers of a step, with half of
// the block idle during the recompute below H = 256, and the per-vertex
// route.
#include "edge_wgmma.cuh"

namespace {

namespace wg = morig_wg;

constexpr int kRows = 64;                  // edge rows per step (D * vertices, padded)
constexpr int kThreads = wg::kThreads;     // 8 warps: two warpgroups
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Four 8x8 b16 matrices from shared memory, lane l giving the address of row
// l % 8 of matrix l / 8; register j holds matrix j's row l / 4, elements
// 2(l % 4), 2(l % 4) + 1: wgmma's A fragment where the four matrices are
// (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(wg::smem_u32(p))
               : "memory");
}

// The same with each matrix transposed: the 16-byte rows lane l addresses
// are the matrix's columns, and register j holds matrix j's row l / 4,
// elements 2(l % 4), 2(l % 4) + 1 of the transpose.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(wg::smem_u32(p))
               : "memory");
}

// 8 bf16 at p[0], p[ld], ..., p[7 ld] as one 16-byte chunk (p[0] first).
__device__ __forceinline__ uint4 column8(const __nv_bfloat16* p, int ld) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = static_cast<uint32_t>(s[2 * k * ld]) | (static_cast<uint32_t>(s[(2 * k + 1) * ld]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// P (1, 2, 4 or 8) contiguous bf16 as fp32, from a 2P-byte aligned address.
template <int P>
__device__ __forceinline__ void load_bf16_row(const __nv_bfloat16* p, float (&x)[P]) {
  if constexpr (P == 8 || P == 4) {
    wg::load_bf16<P>(p, x);
  } else if constexpr (P == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

// The element of (row r, column c) of a step's ds in the dh product's B
// layout (K = H2 columns, N = 64 rows, K-major): core matrix (column group
// c / 8, row group r / 8) at 128 (8 (c / 8) + r / 8) bytes, its 16-byte row r
// % 8 holding columns 8 (c / 8) .. + 7.  kernels/edge_fused.py
// `dh_operand_index` is the same map.
__device__ __forceinline__ int dsb_index(int r, int c) {
  return (((c >> 3) * 8 + (r >> 3)) * 64) + (r & 7) * 8 + (c & 7);
}

// The LN1 column at physical k of K1's product (edge_wgmma.cuh's k order;
// kernels/edge_fused.py `wgmma_k_order`).
template <int H>
__device__ __forceinline__ int k_column(int k) {
  constexpr int P = H < 32 ? 4 : 8, CP = P / 4;
  const int c = k / 16, p16 = k % 16;
  const int q = (p16 % 8) / 2, j = p16 % 2 + 2 * (p16 / 8);
  return (4 * (c / CP) + q) * P + 4 * (c % CP) + j;
}

// The main kernel's shared memory at width H (H1 = H2 = H).
template <int H>
struct BwdLayout {
  static constexpr size_t kDs = static_cast<size_t>(H) * H * 2;       // after W2
  static constexpr size_t kY = kDs + static_cast<size_t>(kRows) * H * 2;
  static constexpr size_t kRed = kY + static_cast<size_t>(kRows) * H * 4;  // [2][64] float2
  static constexpr size_t kStats = kRed + 2 * kRows * sizeof(float2);   // mu1, inv1, mu2, inv2
  static constexpr size_t kBits = kStats + 4 * kRows * sizeof(float);   // two steps' row bits
  static constexpr size_t kBar = kBits + 2 * sizeof(unsigned long long);  // W2's barrier
  static constexpr size_t kBytes = kBar + sizeof(uint64_t);
  static constexpr int kVec = 5 * H;          // dg1 | dbe1 | db2 | dg2 | dbe2
  // 16-byte chunks of a step's scratch tile: 8 H of h, then 8 H of ds
  static constexpr long long kTileChunks = 16LL * H;
  static_assert(kBytes <= static_cast<size_t>(wg::kMaxSmem), "one block fits an SM");
  static_assert(kY - kDs >= static_cast<size_t>(H / 32) * 16 * kThreads || H < 256,
                "the ds area holds the split's fragment exchange");
};

// dh^T = W2 ds^T for the step (ds in `dsb`), written into ys as dh rows
// (fp32, row r at ys + r H).  At H >= 128 warpgroup g takes W2's 64-row
// slabs g, g + 2, ... against all 64 edge rows; below, the one slab (rows
// past H zero) against its warpgroup's 32 edge rows.  W2's rows are read in
// K1's layout, physical k order, 8 k of one output column per 16 bytes, so
// `ldmatrix.trans` gives the A fragments, and row k of the result is LN1
// column k_column(k).  `overlap` runs while the first chain is in flight.
template <int H, class F>
__device__ __forceinline__ void dh_product(const __nv_bfloat16* w2s, const __nv_bfloat16* dsb,
                                           float* ys, F&& overlap) {
  constexpr int kSlabs = H >= 64 ? H / 64 : 1;
  constexpr int kN = H >= 128 ? 64 : 32;
  constexpr int kPerWg = H >= 128 ? kSlabs / 2 : 1;
  constexpr int KC = H / 16;                    // k-chunks of 16 columns of ds
  constexpr int KB = KC < 8 ? KC : 8;           // k-chunks per chain (A registers held)
  const int g = threadIdx.x / 128, w = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int n0 = H >= 128 ? 0 : 32 * g;
  const uint32_t dsb_u = wg::smem_u32(dsb);
#pragma unroll 1
  for (int k = 0; k < kPerWg; ++k) {
    const int i0 = 64 * (H >= 128 ? g + 2 * k : 0) + 16 * w;   // this warp's 16 rows of W2
    // matrix lane / 8: k group i0 / 8 + (lane / 8 & 1), output columns 8 (lane / 16) ..
    const __nv_bfloat16* arow =
        w2s + ((i0 / 8 + (lane / 8 & 1)) * H + (lane / 16) * 8 + lane % 8) * 8;
    float acc[kN / 2];
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) acc[j] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < KC; c0 += KB) {
      uint32_t afr[KB][4];
#pragma unroll
      for (int c = 0; c < KB; ++c) {
        if (i0 < H) {
          ldmatrix_x4_trans(afr[c], arow + 128 * (c0 + c));
        } else {
          afr[c][0] = afr[c][1] = afr[c][2] = afr[c][3] = 0u;
        }
      }
      wg::wgmma_fence();
      wg::fence_operands(acc);
      wg::fence_operands(afr);
#pragma unroll
      for (int c = 0; c < KB; ++c)
        wg::Wgmma<kN>::mma(acc, afr[c],
                           wg::kmajor_desc(dsb_u + ((c0 + c) * 16 + n0 / 8) * 128, 1024, 128), 1);
      wg::wgmma_commit();
      if (k == 0 && c0 == 0) overlap();
      wg::wgmma_wait_all();
      wg::fence_operands(acc);
      wg::fence_operands(afr);
    }
    if (i0 < H) {
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = i0 + lane / 4 + 8 * (e >> 1), r = n0 + 8 * j + 2 * (lane % 4) + (e & 1);
          ys[r * H + k_column<H>(kp)] = acc[4 * j + e];
        }
    }
  }
}

// vecs: g1 | be1 | b2 | g2 | be2 (5 H fp32); w2l: W2 in K1's layout; ymax,
// where not null, gets the recomputed per-vertex max (0 where no edge is
// valid), the forward's output.
template <int H>
__global__ void __launch_bounds__(kThreads) edge_mlp_bwd_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2l, const float* __restrict__ vecs,
    const float* __restrict__ dout, float* __restrict__ da, float* __restrict__ db,
    uint4* __restrict__ scratch, unsigned char* __restrict__ live,
    float* __restrict__ vec_part, float* __restrict__ ymax, int B, int V, int D) {
  using L = BwdLayout<H>;
  constexpr bool kSplit = H == 256;             // K1's column split
  constexpr int NW = kSplit ? H / 2 : H;        // columns of one warpgroup's product
  constexpr int C2 = (H + 31) / 32;             // route channels per lane: lane + 32 k
  constexpr int P = H >= 32 ? H / 32 : 1;       // LN1-backward channels per lane, contiguous
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(smem + L::kDs);
  float* ys = reinterpret_cast<float*>(smem + L::kY);
  float2* red = reinterpret_cast<float2*>(smem + L::kRed);
  float* mu1 = reinterpret_cast<float*>(smem + L::kStats);
  float* inv1 = mu1 + kRows;
  float* mu2 = inv1 + kRows;
  float* inv2 = mu2 + kRows;
  unsigned long long* rowbits = reinterpret_cast<unsigned long long*>(smem + L::kBits);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBar);
  const wg::Vecs<H> vec{vecs};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = tid / wg::kWgThreads;                        // warpgroup
  const int q = lane % 4, rr = 16 * (warp % 4) + lane / 4;   // the product's rows rr, rr + 8
  const int c0 = lane * P;                      // this lane's LN1-backward channels
  const bool own = c0 < H;
  if (tid == 0) {
    wg::mbar_init(bar);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) wg::bulk_load(w2s, w2l, H * H * sizeof(__nv_bfloat16), bar);

  // the gradient sums stay in registers across steps; g1, g2 and be2 are
  // read through L1 where used, which keeps H = 256's product in registers
  float acc_dg1[P], acc_dbe1[P], acc_db2[C2], acc_dg2[C2], acc_dbe2[C2];
#pragma unroll
  for (int k = 0; k < P; ++k) acc_dg1[k] = acc_dbe1[k] = 0.f;
#pragma unroll
  for (int k = 0; k < C2; ++k) acc_db2[k] = acc_dg2[k] = acc_dbe2[k] = 0.f;

  const int vpt = kRows / D;
  const int tiles_per_batch = (V + vpt - 1) / vpt;
  const long long total = static_cast<long long>(B) * tiles_per_batch;
  int parity = 0;
  for (long long t = blockIdx.x; t < total; t += gridDim.x, parity ^= 1) {
    const int bi = static_cast<int>(t / tiles_per_batch);
    const int v0 = static_cast<int>(t % tiles_per_batch) * vpt;
    const int nv = min(vpt, V - v0);
    const long long vb = static_cast<long long>(bi) * V + v0;   // the step's first vertex
    const __nv_bfloat16* table = b + static_cast<long long>(bi) * V * H;

    // ---- live steps only.  The barrier also ends the previous step (its
    // readers of the ds area, ys, the statistics and the other parity's row
    // bits).
    const bool valid = tid < nv * D && mask[vb * D + tid];
    if (tid < kRows) {
      const unsigned bits = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) reinterpret_cast<unsigned*>(rowbits + parity)[warp] = bits;
    }
    const bool is_live = __syncthreads_or(valid);
    if (tid == 0) live[t] = is_live;
    if (!is_live) {
      for (int i = tid; i < nv * H; i += kThreads) {
        da[vb * H + i] = 0.f;
        if (ymax != nullptr) ymax[vb * H + i] = 0.f;
      }
      continue;
    }
    const unsigned long long rows = rowbits[parity];
    uint4* h_out = scratch + t * L::kTileChunks;
    uint4* ds_out = h_out + 8 * H;

    // ---- recompute: the step's rows as one slab of K1, rows rr and rr + 8
    // of this thread, each with its vertex's parity (in K1's units the row's
    // own, vertex v at row v % 64); h to the scratch tile from the fragments
    if (kSplit || g == 0) {
      const int n0 = kSplit ? g * NW : 0;
      const bool ok_lo = rows >> rr & 1ull, ok_hi = rows >> (rr + 8) & 1ull;
      const int vl_lo = rr / D, vl_hi = (rr + 8) / D;
      const __nv_bfloat16* a_lo = a + (vb + vl_lo) * H;
      const __nv_bfloat16* a_hi = a + (vb + vl_hi) * H;
      const __nv_bfloat16* b_lo = ok_lo ? table + nbr[vb * D + rr] * H : nullptr;
      const __nv_bfloat16* b_hi = ok_hi ? table + nbr[vb * D + rr + 8] * H : nullptr;
      unsigned short* hs = reinterpret_cast<unsigned short*>(h_out);
      float acc[NW / 2], m1[2], i1[2], m2[2], i2[2];
#pragma unroll
      for (int k = 0; k < NW / 2; ++k) acc[k] = 0.f;
      wg::mbar_wait(bar, 0);
      wg::slab_product<H, NW, kSplit>(
          a_lo, b_lo, ok_lo, a_hi, b_hi, ok_hi, (v0 + vl_lo) & 1, (v0 + vl_hi) & 1, w2s, vec, n0,
          q, rr, g, red, reinterpret_cast<uint4*>(dsb), acc, m1, i1,
          [&](int c, const uint32_t (&f)[4]) {
            // k-chunk c's registers: 0 row rr, LN1 columns col, col + 1; 1
            // row rr + 8, the same; 2 and 3 columns col + 2, col + 3.  The
            // tile's element (row, col) is at 8 ((row / 8) H + col) + row % 8.
            constexpr int PP = H < 32 ? 4 : 8, CP = PP / 4;
            const int col = (4 * (c / CP) + q) * PP + 4 * (c % CP);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int row = rr + 8 * (j & 1);
              const int e = (((row >> 3) * H) + col + 2 * (j >> 1)) * 8 + (row & 7);
              hs[e] = static_cast<unsigned short>(f[j] & 0xffffu);
              hs[e + 8] = static_cast<unsigned short>(f[j] >> 16);
            }
          });
      wg::ln2_stats<H, NW, kSplit>(acc, vec, n0, q, rr, g, red, m2, i2);
#pragma unroll
      for (int i = 0; i < NW / 8; ++i) {
        const int col = n0 + 8 * i + 2 * q;
        *reinterpret_cast<float2*>(ys + rr * H + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<float2*>(ys + (rr + 8) * H + col) =
            make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
      if (g == 0 && q == 0) {
        mu1[rr] = m1[0];
        inv1[rr] = i1[0];
        mu1[rr + 8] = m1[1];
        inv1[rr + 8] = i1[1];
        mu2[rr] = m2[0];
        inv2[rr] = i2[0];
        mu2[rr + 8] = m2[1];
        inv2[rr + 8] = i2[1];
      }
    }
    __syncthreads();   // t, the statistics and the ds area (free after the exchange)

    // ---- max backward, LN2 backward, relu: ds (bf16) into dsb.  Each
    // output is rebuilt from t with K1's expression.  One pass over the
    // vertex's valid rows finds the max and counts the rows equal to it (the
    // count restarts where the max rises), a second computes ds.
    for (int vl = warp; vl < nv; vl += kWarps) {
      const long long v = vb + vl;
      float best[C2], share[C2], cnt[C2];
      int n_valid = 0;
#pragma unroll
      for (int k = 0; k < C2; ++k) {
        best[k] = wg::kNeg;
        cnt[k] = 0.f;
      }
      for (int d = 0; d < D; ++d) {
        const int r = vl * D + d;
        if (!(rows >> r & 1ull)) continue;
        ++n_valid;
        const float mu = mu2[r], inv = inv2[r];
#pragma unroll
        for (int k = 0; k < C2; ++k) {
          const int c = lane + 32 * k;
          const float out = c < H ? wg::ln_affine(ys[r * H + c], mu, inv, vec.g2()[c],
                                                  vec.be2()[c]) : 0.f;
          if (out > best[k]) {
            best[k] = out;
            cnt[k] = 1.f;
          } else if (out == best[k]) {
            cnt[k] += 1.f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < C2; ++k) {
        const int c = lane + 32 * k;
        share[k] = n_valid > 0 && c < H ? dout[v * H + c] / fmaxf(cnt[k], 1.f) : 0.f;
        if (ymax != nullptr && c < H) ymax[v * H + c] = n_valid > 0 ? best[k] : 0.f;
      }
      for (int d = 0; d < D; ++d) {
        const int r = vl * D + d;
        float ds[C2];
        if (rows >> r & 1ull) {
          const float mu = mu2[r], inv = inv2[r];
          float tr[C2], xn[C2], dxn[C2], p1 = 0.f, p2 = 0.f;
#pragma unroll
          for (int k = 0; k < C2; ++k) {
            const int c = lane + 32 * k;
            const float g2 = c < H ? vec.g2()[c] : 0.f, be2 = c < H ? vec.be2()[c] : 0.f;
            tr[k] = c < H ? ys[r * H + c] : 0.f;
            xn[k] = wg::ln_xn(tr[k], mu, inv);
            const float dy = c < H && wg::ln_affine(tr[k], mu, inv, g2, be2) == best[k]
                                 ? share[k] : 0.f;
            acc_dg2[k] += dy * xn[k];
            acc_dbe2[k] += dy;
            dxn[k] = dy * g2;
            p1 += dxn[k];
            p2 += dxn[k] * xn[k];
          }
          const float m1 = warp_sum(p1) / H, m2 = warp_sum(p2) / H;
#pragma unroll
          for (int k = 0; k < C2; ++k) {
            // t = relu(y + b2) is positive exactly where y + b2 is
            ds[k] = tr[k] > 0.f ? (dxn[k] - m1 - xn[k] * m2) * inv : 0.f;
            acc_db2[k] += ds[k];
          }
        } else {
#pragma unroll
          for (int k = 0; k < C2; ++k) ds[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < C2; ++k) {
          const int c = lane + 32 * k;
          if (c < H) dsb[dsb_index(r, c)] = __float2bfloat16(ds[k]);
        }
      }
    }
    for (int i = tid; i < (kRows - nv * D) * H; i += kThreads)
      dsb[dsb_index(nv * D + i / H, i % H)] = __float2bfloat16(0.f);
    wg::fence_async_shared();   // ds is visible to wgmma
    __syncthreads();

    // ---- dh^T = W2 ds^T on wgmma into ys (t is dead), ds to the scratch
    // tile while the first chain runs
    dh_product<H>(w2s, dsb, ys, [&] {
      for (int e = tid; e < 8 * H; e += kThreads) {
        const int gr = e / H, o = e % H;
        ds_out[e] = column8(dsb + ((o >> 3) * 8 + gr) * 64 + (o & 7), 8);
      }
    });
    __syncthreads();

    // ---- LN1 backward, relu, one edge row per warp: dx over dh, db scatter
    for (int r = warp; r < nv * D; r += kWarps) {
      if (!(rows >> r & 1ull)) continue;
      const long long e = vb * D + r;
      const long long j = nbr[e];
      float* row = ys + r * H;
      float x[P], bv[P], dh[P];
      if (own) {
        load_bf16_row<P>(a + (vb + r / D) * H + c0, x);
        load_bf16_row<P>(table + j * H + c0, bv);
#pragma unroll
        for (int k = 0; k < P; ++k) {
          x[k] = fmaxf(__fadd_rn(x[k], bv[k]), 0.f);
          dh[k] = row[c0 + k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < P; ++k) x[k] = dh[k] = 0.f;
      }
      const float mu = mu1[r], inv = inv1[r];
      float xn[P], dxn[P], p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        xn[k] = wg::ln_xn(x[k], mu, inv);
        acc_dg1[k] += dh[k] * xn[k];
        acc_dbe1[k] += dh[k];
        dxn[k] = own ? dh[k] * vec.g1()[c0 + k] : 0.f;
        p1 += dxn[k];
        p2 += dxn[k] * xn[k];
      }
      const float m1 = warp_sum(p1) / H, m2 = warp_sum(p2) / H;
      if (own) {
        float* dbrow = db + (static_cast<long long>(bi) * V + j) * H + c0;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          // x holds relu(a + b): positive exactly where a + b is
          const float dx = x[k] > 0.f ? (dxn[k] - m1 - xn[k] * m2) * inv : 0.f;
          row[c0 + k] = dx;
          atomicAdd(dbrow + k, __bfloat162float(__float2bfloat16(dx)));
        }
      }
    }
    __syncthreads();

    // ---- da[v]: the sum of v's valid dx rows, d in order
    for (int i = tid; i < nv * H; i += kThreads) {
      const int vl = i / H, c = i % H;
      float s = 0.f;
      for (int d = 0; d < D; ++d)
        if (rows >> (vl * D + d) & 1ull) s += ys[(vl * D + d) * H + c];
      da[vb * H + i] = s;
    }
  }
  wg::mbar_wait(bar, 0);   // W2's copy has landed, also in a block that had no live step

  // ---- the block's vector partial: each warp's sums through shared memory
  // (ys is free once the last step is done with dx), added over the warps in
  // order into the block's row of vec_part
  static_assert(kWarps * L::kVec * sizeof(float) <= L::kRed - L::kY, "warp partials fit in ys");
  float* vp = ys + warp * L::kVec;
  __syncthreads();
  if (own) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      vp[c0 + k] = acc_dg1[k];
      vp[H + c0 + k] = acc_dbe1[k];
    }
  }
#pragma unroll
  for (int k = 0; k < C2; ++k) {
    const int c = lane + 32 * k;
    if (c < H) {
      vp[2 * H + c] = acc_db2[k];
      vp[3 * H + c] = acc_dg2[k];
      vp[4 * H + c] = acc_dbe2[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < L::kVec; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += ys[w * L::kVec + i];
    vec_part[static_cast<long long>(blockIdx.x) * L::kVec + i] = s;
  }
}

// ---------------------------------------------------------------------------
// dW2 = sum over the live steps of h^T ds, from the scratch tiles
// ---------------------------------------------------------------------------

constexpr int kDw2Threads = 128;   // one warpgroup
constexpr int kDw2Stages = 3;

template <int H>
struct Dw2Layout {
  static constexpr int kMW = H < 64 ? H : 64;          // h columns of a block's slab
  static constexpr int kNW = H < 128 ? H : 128;        // columns of one product
  static constexpr size_t kA = 8 * kMW * 16;           // the slab's h^T in a stage
  static constexpr size_t kStage = kA + 8 * H * 16;    // then ds
  static constexpr size_t kBytes = kDw2Stages * kStage;
};

// Block (split, slab): dW2 rows 64 slab .. + 63 (all H rows below 64) over
// the live steps t = split, split + S, ... of n_steps; writes its rows of
// part[split] (H x H fp32).  live[t] != 0 marks a step whose tile was
// written.
template <int H>
__global__ void __launch_bounds__(kDw2Threads) edge_mlp_dw2_kernel(
    const uint4* __restrict__ scratch, const unsigned char* __restrict__ live, int n_steps,
    float* __restrict__ part) {
  using L = Dw2Layout<H>;
  constexpr int NP = H / L::kNW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int split = blockIdx.x, slab = blockIdx.y, S = gridDim.x;
  auto next_live = [&](int t) {
    while (t < n_steps && !live[t]) t += S;
    return t;
  };
  auto load = [&](int stage, int t) {
    unsigned char* st = smem + stage * L::kStage;
    const uint4* tile = scratch + static_cast<long long>(t) * 16 * H;
    for (int e = tid; e < 8 * L::kMW; e += kDw2Threads)
      wg::cp_async16(st + e * 16, tile + (e / L::kMW) * H + slab * 64 + e % L::kMW);
    for (int e = tid; e < 8 * H; e += kDw2Threads)
      wg::cp_async16(st + L::kA + e * 16, tile + 8 * H + e);
  };

  float acc[NP][L::kNW / 2];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < L::kNW / 2; ++j) acc[p][j] = 0.f;

  // the ring's first stages, one commit group each
  int t_next = next_live(split), issued = 0;
#pragma unroll
  for (int s = 0; s < kDw2Stages - 1; ++s) {
    if (t_next < n_steps) {
      load(issued++ % kDw2Stages, t_next);
      t_next = next_live(t_next + S);
    }
    wg::cp_async_commit();
  }
  const bool rows_ok = 16 * w < L::kMW;          // warps past H's rows multiply zeros
  for (int k = 0; k < issued; ++k) {
    if (t_next < n_steps) {                       // into the stage the last tile freed
      load(issued++ % kDw2Stages, t_next);
      t_next = next_live(t_next + S);
    }
    wg::cp_async_commit();
    wg::cp_async_wait_group<kDw2Stages - 1>();        // tile k's copies have landed
    wg::fence_async_shared();                         // ... and are visible to wgmma
    __syncthreads();
    const unsigned char* st = smem + (k % kDw2Stages) * L::kStage;
    uint32_t afr[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (rows_ok) {
        const int m = 16 * w + (l / 8 & 1) * 8 + l % 8, g = 2 * c + l / 16;
        ldmatrix_x4(afr[c], st + (g * L::kMW + m) * 16);
      } else {
        afr[c][0] = afr[c][1] = afr[c][2] = afr[c][3] = 0u;
      }
    }
    const uint32_t bu = wg::smem_u32(st + L::kA);
    wg::wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) wg::fence_operands(acc[p]);
    wg::fence_operands(afr);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wg::Wgmma<L::kNW>::mma(acc[p], afr[c],
                               wg::kmajor_desc(bu + (2 * c * H + p * L::kNW) * 16, 16 * H, 128), 1);
    wg::wgmma_commit();
    wg::wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) wg::fence_operands(acc[p]);
    wg::fence_operands(afr);
    __syncthreads();                              // every warp is done with this stage
  }

  if (rows_ok) {
    float* out = part + static_cast<long long>(split) * H * H;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < L::kNW / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = slab * 64 + 16 * w + l / 4 + 8 * h;
          const int o = p * L::kNW + 8 * j + 2 * (l % 4);
          *reinterpret_cast<float2*>(out + i * H + o) =
              make_float2(acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]);
        }
  }
}

// out[i] = sum over p in order of part[p, i]: the fixed-order reduction of
// the per-block partials.  A block takes 32 consecutive i; its 8 warps sum
// the parts p = warp, warp + 8, ... in order, then the 8 sums are added in
// warp order.
__global__ void __launch_bounds__(256) sum_parts_kernel(const float* __restrict__ part,
                                                        float* __restrict__ out, int n_parts,
                                                        int n) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n)
    for (int p = w; p < n_parts; p += 8) s += part[static_cast<long long>(p) * n + i];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][lane];
    out[i] = t;
  }
}

cudaError_t sum_parts(const float* part, float* out, int n_parts, int n, cudaStream_t s) {
  sum_parts_kernel<<<(n + 31) / 32, 256, 0, s>>>(part, out, n_parts, n);
  return cudaGetLastError();
}

// The persistent grid of K6's main kernel at width H for B*V vertices of
// degree D.
template <int H>
cudaError_t bwd_grid(int B, int V, int D, int* grid) {
  static wg::GridCache cache;
  const int vpt = kRows / D;
  return wg::persistent_grid(edge_mlp_bwd_kernel<H>, BwdLayout<H>::kBytes,
                             static_cast<long long>(B) * ((V + vpt - 1) / vpt), cache, grid);
}

// The dW2 kernel's splits at width H: one wave of blocks over the SMs, H/64
// slabs each (one below 64).  Sets its shared-memory size once.
template <int H>
cudaError_t dw2_grid(int* splits) {
  static int cached = 0;
  if (cached == 0) {
    cudaError_t err = cudaFuncSetAttribute(edge_mlp_dw2_kernel<H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Dw2Layout<H>::kBytes));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int slabs = H < 64 ? 1 : H / 64;
    cached = sms / slabs > 0 ? sms / slabs : 1;
  }
  *splits = cached;
  return cudaSuccess;
}

template <int H>
cudaError_t grids(int B, int V, int D, int* grid, int* splits) {
  cudaError_t err = bwd_grid<H>(B, V, D, grid);
  return err != cudaSuccess ? err : dw2_grid<H>(splits);
}

template <int H>
cudaError_t launch_dw2(const void* scratch, const void* live, int n_steps, void* dw2_part,
                       void* dw2, int splits, cudaStream_t s) {
  int g = 0;
  cudaError_t err = dw2_grid<H>(&g);
  if (err != cudaSuccess) return err;
  if (g != splits) return cudaErrorInvalidValue;   // partials sized for another grid
  edge_mlp_dw2_kernel<H><<<dim3(g, H < 64 ? 1 : H / 64), kDw2Threads, Dw2Layout<H>::kBytes, s>>>(
      static_cast<const uint4*>(scratch), static_cast<const unsigned char*>(live), n_steps,
      static_cast<float*>(dw2_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_parts(static_cast<const float*>(dw2_part), static_cast<float*>(dw2), g, H * H, s);
}

template <int H>
cudaError_t launch_bwd(const void* a, const void* b, const void* nbr, const void* mask,
                       const void* w2, const void* vecs, const void* dout, void* da, void* db,
                       void* dw2, void* vec, void* scratch, void* live, void* dw2_part,
                       void* vec_part, void* ymax, int B, int V, int D, int grid, int splits,
                       cudaStream_t s) {
  int g = 0;
  cudaError_t err = bwd_grid<H>(B, V, D, &g);
  if (err != cudaSuccess) return err;
  if (g != grid) return cudaErrorInvalidValue;   // partials sized for another grid
  const int vpt = kRows / D;
  const long long n_steps = static_cast<long long>(B) * ((V + vpt - 1) / vpt);
  if (n_steps > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (g > 0) {
    edge_mlp_bwd_kernel<H><<<g, kThreads, BwdLayout<H>::kBytes, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<const long long*>(nbr), static_cast<const unsigned char*>(mask),
        static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(vecs),
        static_cast<const float*>(dout), static_cast<float*>(da), static_cast<float*>(db),
        static_cast<uint4*>(scratch), static_cast<unsigned char*>(live),
        static_cast<float*>(vec_part), static_cast<float*>(ymax), B, V, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // with no steps (an empty batch) the dW2 blocks find no tile and the sums
  // of zero partials write zeros
  err = launch_dw2<H>(scratch, live, static_cast<int>(n_steps), dw2_part, dw2, splits, s);
  if (err != cudaSuccess) return err;
  return sum_parts(static_cast<const float*>(vec_part), static_cast<float*>(vec), g,
                   BwdLayout<H>::kVec, s);
}

}  // namespace

#define MORIG_BWD_WIDTHS(CALL) \
  switch (H1) {                \
    case 16: return CALL(16);  \
    case 32: return CALL(32);  \
    case 64: return CALL(64);  \
    case 128: return CALL(128); \
    case 256: return CALL(256); \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// The grids K6 will launch for these shapes: the main kernel's `grid` (the
// wrapper sizes vec_part (grid, 2*H1 + 3*H2) with it) and the dW2 kernel's
// `splits` (dw2_part (splits, H1, H2)).
extern "C" int edge_mlp_backward_grid(int B, int V, int D, int H1, int H2, int* grid,
                                      int* splits) {
  if (H1 != H2 || D < 1 || D > 16) return static_cast<int>(cudaErrorInvalidValue);
#define MORIG_GRID(H) grids<H>(B, V, D, grid, splits)
  MORIG_BWD_WIDTHS(MORIG_GRID)
#undef MORIG_GRID
}

// a, b (B,V,H) bf16, 16-byte aligned; nbr (B,V,D) int64; mask (B,V,D) bool;
// w2 (H,H) in K1's layout (kernels/edge_fused.py `wgmma_w2_layout`); vecs
// (5H fp32: g1 | be1 | b2 | g2 | be2); dout (B,V,H) fp32.  Writes da
// (B,V,H), adds into db (B,V,H, zeroed by the caller), writes dw2 (H,H) and
// vec (5H: dg1 | dbe1 | db2 | dg2 | dbe2), all fp32, and, where ymax is not
// null, the recomputed forward (B,V,H) fp32, using scratch (per step 256 H
// bytes: B * ceil(V / (64 / D)) steps), live (a byte per step) and the
// partial buffers.  Requires H1 == H2 in {16, 32, 64, 128, 256}, 1 <= D <=
// 16, every nbr entry in [0, V) and `grid`, `splits` from
// edge_mlp_backward_grid.  Returns the first cudaGetLastError() of its four
// launches.
extern "C" int edge_mlp_backward(const void* a, const void* b, const void* nbr, const void* mask,
                                 const void* w2, const void* vecs, const void* dout, void* da,
                                 void* db, void* dw2, void* vec, void* scratch, void* live,
                                 void* dw2_part, void* vec_part, void* ymax, int B, int V, int D,
                                 int H1, int H2, int grid, int splits, void* stream) {
  if (H1 != H2 || D < 1 || D > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MORIG_BWD(H)                                                                         \
  launch_bwd<H>(a, b, nbr, mask, w2, vecs, dout, da, db, dw2, vec, scratch, live, dw2_part, \
                vec_part, ymax, B, V, D, grid, splits, s)
  MORIG_BWD_WIDTHS(MORIG_BWD)
#undef MORIG_BWD
}

// The dW2 kernel alone: dw2 (H,H) fp32 = sum over the steps t < n_steps with
// live[t] != 0 of h_t^T ds_t from scratch (per step an h and a ds part of 64
// x H bf16 in the chunk layout above; kernels/edge_fused.py
// `pack_dw2_scratch`), through dw2_part (splits, H, H).
extern "C" int edge_mlp_dw2_grid(int H1, int* splits) {
#define MORIG_SPLITS(H) dw2_grid<H>(splits)
  MORIG_BWD_WIDTHS(MORIG_SPLITS)
#undef MORIG_SPLITS
}

extern "C" int edge_mlp_dw2(const void* scratch, const void* live, void* dw2_part, void* dw2,
                            int n_steps, int H1, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MORIG_DW2(H) launch_dw2<H>(scratch, live, n_steps, dw2_part, dw2, splits, s)
  MORIG_BWD_WIDTHS(MORIG_DW2)
#undef MORIG_DW2
}

#undef MORIG_BWD_WIDTHS
