// K6 — one-pass backward of the fused EdgeMLP tail (K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel morig_tpu/kernels/edge_fused.py `fused_edge_mlp_bwd`
// (:429; body `_bwd_kernel` :320-425).  It is the backward of every edge
// layer on the training path (nn/gcu.py EdgeMLP with train=True, through
// kernels/edge_fused.py `fused_edge_mlp_trainable`).  Given the forward's
// inputs and dout = dL/dout (B,V,H2), it returns
//
//   da (B,V,H1), db_table (B,V,H1), dW2 (H1,H2), db2, dg1, dbe1, dg2, dbe2
//
// in fp32.  The forward is recomputed in the kernel with K1's own step code
// (edge_tail.cuh), so each recomputed per-edge output equals the one K1 gave
// the loss bit for bit; the max backward then routes dout to the valid edges
// that equal the max by exact equality, splitting ties equally (dout / count;
// 0 on rows with no valid edge).  Then, in fp32 per edge row: LN2 backward,
// relu, ds -> dh = bf16(ds) @ bf16(W2)^T and dW2 += bf16(h)^T @ bf16(ds) on
// the tensor cores (WMMA, fp32 sums), LN1 backward, relu -> dx; da[v] is the
// fp32 sum over v's edges of dx (d in order) and db_table[nbr] += bf16(dx),
// the TPU kernel's precision (`precise=False`).
//
// What does not carry over from the TPU: there the grid runs in order, so the
// db_table block and the dW2/vector sums stay resident across grid steps.
// Here blocks run in parallel: db_table is a scatter of fp32 atomics into a
// buffer the wrapper zeroes (the order of the adds varies from run to run, so
// db_table is not bitwise deterministic); dW2 and the five vector sums are
// per-block partials (dW2 read-modified-written by its owning warp in the
// block's slice of a global buffer, the vectors in registers and then over
// the block's warps in shared memory) summed over the blocks in a fixed order
// by a second small kernel, so they are
// deterministic for a given grid.
//
// Shared memory: W2 resident (bf16, up to 128 KB at 256x256), one step's h
// (64 x H1 bf16) and y (64 x H2 fp32); ds (bf16) is written over the first
// half of each y row, and dh (fp32) over y once both products have read ds.
// x, xn1 and the LN1 sign are recomputed from a, b and the kept per-row
// statistics instead of being held.  At H=256 that is 225 KB: one block of
// 8 warps per SM.
//
// What bounds it on the H100: three products of 2*E*H1*H2 FLOPs each (the
// recompute, dh and dW2; E = B*V*D edge rows) against reading a, b, dout and
// writing da and db_table, so the tensor cores at every width; this first
// version runs WMMA at one block per SM at H=256 and re-reads dW2's partial
// tiles from L2 on every step (see PERF.md for its time against the bound).
#include "edge_tail.cuh"

namespace {

using namespace morig_edge;

template <int H1, int H2>
struct BwdLayout {
  using T = Tail<H1, H2>;
  static constexpr size_t kH = T::kW2Bytes;             // hs
  static constexpr size_t kY = kH + T::kHBytes;         // ys, then ds and dh
  static constexpr size_t kStats = kY + T::kYBytes;     // per-row LN1 mu, inv
  static constexpr size_t kBytes = kStats + 2 * kRows * sizeof(float);
  static constexpr int kVec = 2 * H1 + 3 * H2;          // dg1 | dbe1 | db2 | dg2 | dbe2
};

template <int H1, int H2>
__global__ void __launch_bounds__(kThreads) edge_mlp_bwd_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    const long long* __restrict__ nbr, const unsigned char* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ g1, const float* __restrict__ be1,
    const float* __restrict__ g2, const float* __restrict__ be2,
    const float* __restrict__ dout, float* __restrict__ da, float* __restrict__ db,
    float* __restrict__ dw2_part, float* __restrict__ vec_part, int B, int V, int D) {
  static_assert(H1 == H2, "dh is written over the y buffer");
  using T = Tail<H1, H2>;
  using L = BwdLayout<H1, H2>;
  constexpr int C1 = T::C1, C2 = T::C2;
  constexpr int kDsLd = 2 * H2;               // ds rows in bf16 elements, inside y rows
  constexpr int NT1 = H1 / 16, NT2 = H2 / 16;
  constexpr int FRH = (T::MT * NT1 + kWarps - 1) / kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  T tail(reinterpret_cast<__nv_bfloat16*>(smem), reinterpret_cast<__nv_bfloat16*>(smem + L::kH),
         reinterpret_cast<float*>(smem + L::kY), w2, b2, g1, be1, g2, be2);
  float* mu1 = reinterpret_cast<float*>(smem + L::kStats);
  float* inv1 = mu1 + kRows;
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(tail.ys);
  float* dhs = tail.ys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc_dg1[C1], acc_dbe1[C1], acc_db2[C2], acc_dg2[C2], acc_dbe2[C2];
#pragma unroll
  for (int q = 0; q < C1; ++q) acc_dg1[q] = acc_dbe1[q] = 0.f;
#pragma unroll
  for (int q = 0; q < C2; ++q) acc_db2[q] = acc_dg2[q] = acc_dbe2[q] = 0.f;
  float* part = dw2_part + static_cast<long long>(blockIdx.x) * H1 * H2;

  const int vpt = kRows / D;
  const int tiles_per_batch = (V + vpt - 1) / vpt;
  const long long total = static_cast<long long>(B) * tiles_per_batch;
  bool first = true;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const int bi = static_cast<int>(t / tiles_per_batch);
    const int v0 = static_cast<int>(t % tiles_per_batch) * vpt;
    const int nv = min(vpt, V - v0);
    const __nv_bfloat16* table = b + static_cast<long long>(bi) * V * H1;

    // ---- recompute: h, y (K1's step code)
    __syncthreads();   // the previous step is done with hs, ys and the statistics
    tail.ln1_rows(bi, v0, nv, V, D, a, table, 0, V, 0, nbr, mask, mu1, inv1);
    __syncthreads();
    tail.dense();

    // ---- max backward, LN2 backward, relu: ds (bf16) over each y row
    for (int vl = warp; vl < nv; vl += kWarps) {
      const long long v = static_cast<long long>(bi) * V + v0 + vl;
      const unsigned char* mrow = mask + v * D;
      float best[C2], share[C2], cnt[C2];
      int n_valid;
      tail.vertex_max(vl, D, mrow, best, n_valid);
#pragma unroll
      for (int q = 0; q < C2; ++q) cnt[q] = 0.f;
      for (int d = 0; d < D; ++d) {
        if (!mrow[d]) continue;
        float s[C2], xn[C2], out[C2], inv;
        tail.ln2_row(vl * D + d, s, xn, out, inv);
#pragma unroll
        for (int q = 0; q < C2; ++q) cnt[q] += out[q] == best[q] ? 1.f : 0.f;
      }
#pragma unroll
      for (int q = 0; q < C2; ++q) {
        const int c = lane + 32 * q;
        share[q] = n_valid > 0 && c < H2 ? dout[v * H2 + c] / fmaxf(cnt[q], 1.f) : 0.f;
      }
      for (int d = 0; d < D; ++d) {
        const int r = vl * D + d;
        float ds[C2];
        if (mrow[d]) {
          float s[C2], xn[C2], out[C2], dxn[C2], inv;
          tail.ln2_row(r, s, xn, out, inv);
          float p1 = 0.f, p2 = 0.f;
#pragma unroll
          for (int q = 0; q < C2; ++q) {
            const float dy = out[q] == best[q] ? share[q] : 0.f;
            acc_dg2[q] += dy * xn[q];
            acc_dbe2[q] += dy;
            dxn[q] = dy * tail.g2r[q];
            p1 += dxn[q];
            p2 += dxn[q] * xn[q];
          }
          const float m1 = warp_sum(p1) / H2, m2 = warp_sum(p2) / H2;
#pragma unroll
          for (int q = 0; q < C2; ++q) {
            ds[q] = s[q] > 0.f ? (dxn[q] - m1 - xn[q] * m2) * inv : 0.f;
            acc_db2[q] += ds[q];
          }
        } else {
#pragma unroll
          for (int q = 0; q < C2; ++q) ds[q] = 0.f;
        }
        __syncwarp();   // the warp has read y row r before ds overwrites it
#pragma unroll
        for (int q = 0; q < C2; ++q) {
          const int c = lane + 32 * q;
          if (c < H2) dss[r * kDsLd + c] = __float2bfloat16(ds[q]);
        }
      }
    }
    for (int i = threadIdx.x; i < (kRows - nv * D) * H2; i += kThreads)
      dss[(nv * D + i / H2) * kDsLd + i % H2] = __float2bfloat16(0.f);
    __syncthreads();

    // ---- dW2 += h^T ds: each warp owns fixed tiles of the block's partial
    for (int tix = warp; tix < NT1 * NT2; tix += kWarps) {
      const int m = tix / NT2, n = tix % NT2;
      float* tile = part + m * 16 * H2 + n * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (first) {
        wmma::fill_fragment(acc, 0.f);
      } else {
        wmma::load_matrix_sync(acc, tile, H2, wmma::mem_row_major);
      }
#pragma unroll
      for (int k = 0; k < kRows / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, tail.hs + k * 16 * H1 + m * 16, H1);
        wmma::load_matrix_sync(fb, dss + k * 16 * kDsLd + n * 16, kDsLd);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(tile, acc, H2, wmma::mem_row_major);
    }
    first = false;

    // ---- dh = ds @ W2^T
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dacc[FRH];
#pragma unroll
    for (int f = 0; f < FRH; ++f) {
      const int tix = warp + f * kWarps;
      wmma::fill_fragment(dacc[f], 0.f);
      if (tix < T::MT * NT1) {
        const int m = tix / NT1, n = tix % NT1;
#pragma unroll
        for (int k = 0; k < NT2; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dss + m * 16 * kDsLd + k * 16, kDsLd);
          wmma::load_matrix_sync(fb, tail.w2s + n * 16 * H2 + k * 16, H2);
          wmma::mma_sync(dacc[f], fa, fb, dacc[f]);
        }
      }
    }
    __syncthreads();   // both products are done reading ds before dh overwrites it
#pragma unroll
    for (int f = 0; f < FRH; ++f) {
      const int tix = warp + f * kWarps;
      if (tix < T::MT * NT1) {
        const int m = tix / NT1, n = tix % NT1;
        wmma::store_matrix_sync(dhs + m * 16 * H1 + n * 16, dacc[f], H1, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // ---- LN1 backward, relu: dx; da (sum over the vertex's edges), db scatter
    for (int vl = warp; vl < nv; vl += kWarps) {
      const long long v = static_cast<long long>(bi) * V + v0 + vl;
      const __nv_bfloat16* ar = a + v * H1;
      float dav[C1];
#pragma unroll
      for (int q = 0; q < C1; ++q) dav[q] = 0.f;
      for (int d = 0; d < D; ++d) {
        const long long e = v * D + d;
        if (!mask[e]) continue;
        const int r = vl * D + d;
        const long long j = nbr[e];
        float x[C1], xn[C1], dxn[C1];
        tail.edge_input(ar, table + j * H1, x);
        const float mu = mu1[r], inv = inv1[r];
        float p1 = 0.f, p2 = 0.f;
#pragma unroll
        for (int q = 0; q < C1; ++q) {
          const int c = lane + 32 * q;
          const float dh = c < H1 ? dhs[r * H1 + c] : 0.f;
          xn[q] = ln_norm(x[q], mu, inv);
          acc_dg1[q] += dh * xn[q];
          acc_dbe1[q] += dh;
          dxn[q] = dh * tail.g1r[q];
          p1 += dxn[q];
          p2 += dxn[q] * xn[q];
        }
        const float m1 = warp_sum(p1) / H1, m2 = warp_sum(p2) / H1;
        float* dbrow = db + (static_cast<long long>(bi) * V + j) * H1;
#pragma unroll
        for (int q = 0; q < C1; ++q) {
          const int c = lane + 32 * q;
          // x holds relu(a + b): positive exactly where a + b is
          const float dx = x[q] > 0.f ? (dxn[q] - m1 - xn[q] * m2) * inv : 0.f;
          dav[q] += dx;
          if (c < H1) atomicAdd(dbrow + c, __bfloat162float(__float2bfloat16(dx)));
        }
      }
#pragma unroll
      for (int q = 0; q < C1; ++q) {
        const int c = lane + 32 * q;
        if (c < H1) da[v * H1 + c] = dav[q];
      }
    }
  }

  // ---- the block's vector partial: each warp's sums through shared memory
  // (ys is free once the last step is done with dh), added over the warps in
  // order into the block's row of vec_part
  static_assert(kWarps * L::kVec * sizeof(float) <= T::kYBytes, "warp partials fit in ys");
  float* vp = tail.ys + warp * L::kVec;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < C1; ++q) {
    const int c = lane + 32 * q;
    if (c < H1) {
      vp[c] = acc_dg1[q];
      vp[H1 + c] = acc_dbe1[q];
    }
  }
#pragma unroll
  for (int q = 0; q < C2; ++q) {
    const int c = lane + 32 * q;
    if (c < H2) {
      vp[2 * H1 + c] = acc_db2[q];
      vp[2 * H1 + H2 + c] = acc_dg2[q];
      vp[2 * H1 + 2 * H2 + c] = acc_dbe2[q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L::kVec; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += tail.ys[w * L::kVec + i];
    vec_part[static_cast<long long>(blockIdx.x) * L::kVec + i] = s;
  }
}

// out[i] = sum over p in order of part[p, i]: the fixed-order reduction of
// the per-block partials.
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int n_parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[static_cast<long long>(p) * n + i];
  out[i] = s;
}

// The persistent grid of K6 at width H for B*V vertices of degree D.
template <int H>
cudaError_t bwd_grid(int B, int V, int D, int* grid) {
  static GridCache cache;
  const int vpt = kRows / D;
  return persistent_grid(edge_mlp_bwd_kernel<H, H>, BwdLayout<H, H>::kBytes,
                         static_cast<long long>(B) * ((V + vpt - 1) / vpt), cache, grid);
}

cudaError_t sum_parts(const float* part, float* out, int n_parts, int n, cudaStream_t s) {
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, out, n_parts, n);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bwd(const void* a, const void* b, const void* nbr, const void* mask,
                       const void* w2, const void* b2, const void* g1, const void* be1,
                       const void* g2, const void* be2, const void* dout, void* da, void* db,
                       void* dw2, void* vec, void* dw2_part, void* vec_part, int B, int V,
                       int D, int grid, cudaStream_t s) {
  int g = 0;
  cudaError_t err = bwd_grid<H>(B, V, D, &g);
  if (err != cudaSuccess) return err;
  if (g != grid) return cudaErrorInvalidValue;   // partials sized for another grid
  if (g > 0) {
    edge_mlp_bwd_kernel<H, H><<<g, kThreads, BwdLayout<H, H>::kBytes, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<const long long*>(nbr), static_cast<const unsigned char*>(mask),
        static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
        static_cast<const float*>(g1), static_cast<const float*>(be1),
        static_cast<const float*>(g2), static_cast<const float*>(be2),
        static_cast<const float*>(dout), static_cast<float*>(da), static_cast<float*>(db),
        static_cast<float*>(dw2_part), static_cast<float*>(vec_part), B, V, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // with no blocks (an empty batch) the sums of zero partials write zeros
  err = sum_parts(static_cast<const float*>(dw2_part), static_cast<float*>(dw2), g, H * H, s);
  if (err != cudaSuccess) return err;
  return sum_parts(static_cast<const float*>(vec_part), static_cast<float*>(vec), g,
                   BwdLayout<H, H>::kVec, s);
}

}  // namespace

// The grid K6 will launch for these shapes: the wrapper sizes the partial
// buffers with it (dw2_part (grid, H1, H2), vec_part (grid, 2*H1 + 3*H2)).
extern "C" int edge_mlp_backward_grid(int B, int V, int D, int H1, int H2, int* grid) {
  if (H1 != H2 || D < 1 || D > 16) return static_cast<int>(cudaErrorInvalidValue);
  switch (H1) {
    case 16: return bwd_grid<16>(B, V, D, grid);
    case 32: return bwd_grid<32>(B, V, D, grid);
    case 64: return bwd_grid<64>(B, V, D, grid);
    case 128: return bwd_grid<128>(B, V, D, grid);
    case 256: return bwd_grid<256>(B, V, D, grid);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a, b (B,V,H) bf16; nbr (B,V,D) int64; mask (B,V,D) bool; w2 (H,H) bf16;
// b2, g1, be1, g2, be2 (H,) fp32; dout (B,V,H) fp32.  Writes da (B,V,H),
// adds into db (B,V,H, zeroed by the caller), writes dw2 (H,H) and vec
// (5H: dg1 | dbe1 | db2 | dg2 | dbe2), all fp32, using the partial buffers.
// Requires H1 == H2 in {16, 32, 64, 128, 256}, 1 <= D <= 16, every nbr entry
// in [0, V) and `grid` from edge_mlp_backward_grid.  Returns the first
// cudaGetLastError() of its three launches.
extern "C" int edge_mlp_backward(const void* a, const void* b, const void* nbr, const void* mask,
                                 const void* w2, const void* b2, const void* g1, const void* be1,
                                 const void* g2, const void* be2, const void* dout, void* da,
                                 void* db, void* dw2, void* vec, void* dw2_part, void* vec_part,
                                 int B, int V, int D, int H1, int H2, int grid, void* stream) {
  if (H1 != H2 || D < 1 || D > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MORIG_BWD(H)                                                                       \
  launch_bwd<H>(a, b, nbr, mask, w2, b2, g1, be1, g2, be2, dout, da, db, dw2, vec, dw2_part, \
                vec_part, B, V, D, grid, s)
  switch (H1) {
    case 16: return MORIG_BWD(16);
    case 32: return MORIG_BWD(32);
    case 64: return MORIG_BWD(64);
    case 128: return MORIG_BWD(128);
    case 256: return MORIG_BWD(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MORIG_BWD
}
