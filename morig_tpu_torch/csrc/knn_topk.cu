// K2 and K4 — batched cosine top-k with and without row gather, for Hopper
// (sm_90a).
//
// K2 replaces the TPU kernel morig_tpu/kernels/knn_fused.py `_fused_raw` with
// `values` (:109; body `_knn_gather_kernel` :65 -> `_knn_body` :71), reached
// through `knn_batched` (:271) from nn/corrnet.py (vismask 1-NN) and
// nn/deformnet.py (visible voting, invisible completion).  K4 replaces
// `_fused_raw` without `values` (body `_knn_kernel` :61): the same kernel with
// the gather compiled out (kGather = false).  Per batch row b and query n:
//
//   score_j = <bf16(q), bf16(c_j)> (exact products, fp32 sums), -1e30 where
//   cand_mask is false; the k largest by (score descending, index
//   ascending); slots whose score is <= -5e29 (an all-masked row, or fewer
//   than k valid candidates) hold index 0 and score -1e30;
//   gathered[j] = values[idx_j] exactly (fp32).
//
// What bounds it on the H100: the N*P*64 bf16 products of a batch row
// against the bytes of q, c, the mask and the value rows read and of the
// outputs written.  At the serving path's shapes (B*T=20, V=1536, P=1024)
// each is 0.004-0.006 ms a case, about 0.019 ms over its three cases
// (chip_smoke.py prints each case's bound).  The (N, P) similarity never
// reaches device memory: it would be 126 MB per vismask call at B*T=20,
// written and read again k times.
//
// Design.  A block is one warpgroup on one slab of 64 queries of one batch
// row; the grid is the slabs.  The slab's 64 x 64 bf16 queries are loaded
// once into wgmma's A registers (wgmma.cuh: four k16 chunks of uint32_t[4],
// 16 registers a thread; rows >= N are zeros and never written).
// Candidates stream through a kStages-deep shared-memory ring of tiles of
// kNC candidates x 64 channels: each 128-byte candidate row arrives as
// eight 16-byte cp.async copies, each landing where wgmma's no-swizzle
// K-major B layout wants it (core matrix (k/8, n) at (k/8 * kNC + n) * 16
// bytes), with the tile's mask as kNC/32 ballot words, and the copies of
// tile t + kStages - 1 are in flight during tile t's product.  The product
// is four m64nNCk16 wgmma into kNC/2 fp32 accumulators a thread (scale_d = 0
// on the first chunk).  Candidates of one batch row are at most 1536 x 128
// bytes, which L2 holds, so the slabs' re-reads cost L2 bandwidth, not
// HBM.  On the H100 tiles of 64 candidates beat tiles of 128; two
// warpgroups per block sharing one ring were faster at the serving shapes
// but slower at the training step's 128 slabs (64 blocks on 132 SMs), so a
// block is one warpgroup.
//
// Top-k in registers.  By wgmma.cuh's layout thread l of warp w holds rows
// r = 16w + l/4 and r + 8 at columns 8i + 2(l%4) + {0, 1}; it keeps for
// each of its two rows a sorted top-K list (K scores, K indices; K is k,
// one instantiation for each k from 1 to 8), visits its columns in
// increasing index order, tile by tile, and takes a candidate only when it
// is strictly greater than the list's last score, so within a thread equal
// scores keep the smaller index; masked columns and columns >= P never
// enter (the lists start at score -1e30, index 0).  At k = 1 that is one
// predicated compare per column.  At k > 1 an insertion costs ~6K
// instructions and one lane inserting stalls its warp, so a tile's scores
// go to a per-thread shared-memory row first and only the survivors are
// offered: valid columns not below the highest last score of the quad
// (below it the quad already holds K better ones); the warp loops as long
// as its busiest lane has survivors.  After the last tile the four lanes of
// a quad, which share the rows, merge their lists in K rounds of
// __shfl_xor: each round takes the quad's best head by (score descending,
// index ascending) and its owner pops it.  That is the union's top k by
// (score, -index), the first-index-wins order of the TPU kernel's argmax
// sweeps (knn_fused.py:85-93).  Two equal candidate rows get bit-equal
// scores wherever they sit: every column's sum is the same sequence of
// tensor-core steps (the card tests check it).  The quad then writes the
// indices and scores and, with kGather, copies each selected value row
// together (16-byte vectors where Cv % 4 == 0 and values is 16-byte
// aligned, else floats; 64-bit offsets).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_wgmma.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = morig_wg;

constexpr int kC = 64;               // the feature width (CorrNet's embedding)
constexpr int kM = 64;               // queries per slab: wgmma's M
constexpr int kNC = 64;              // candidates per tile: wgmma's N
constexpr int kStages = 3;           // ring depth
constexpr int kThreads = 128;        // one warpgroup
constexpr int kTileBytes = kNC * kC * 2;
constexpr int kMaskWords = kNC / 32;
// a thread's scores of one tile (K > 1): kNC / 2 floats, padded so that the
// 16-byte stores of 8 neighbouring threads fall on distinct banks
constexpr int kScStride = kNC / 2 + 4;
constexpr int kScBytes = kThreads * kScStride * 4;
constexpr size_t kSmem =
    static_cast<size_t>(kStages) * (kTileBytes + kMaskWords * 4) + kScBytes;
constexpr float kNeg = -1e30f;
static_assert(kNC % 32 == 0 && kNC <= kThreads && (8 * kNC) % kThreads == 0, "tile shape");

// Candidate rows [p0, p0 + kNC) of one batch row into a ring stage: chunk g
// (channels 8g..8g+7) of row n to byte (g * kNC + n) * 16.  A warp copies 8
// rows x 4 chunks per instruction, so each 8-lane phase writes 8 rows' chunks
// to 8 distinct bank groups and every 32-byte sector it reads is whole.
// Rows >= P are not read (their slots keep stale bytes; their mask bit is 0).
__device__ __forceinline__ void load_tile(unsigned char* stage, const __nv_bfloat16* cand_b,
                                          int p0, int P, int tid) {
#pragma unroll
  for (int j = 0; j < 8 * kNC / kThreads; ++j) {
    const int e = tid + j * kThreads, w = e / 32, l = e % 32;
    const int n = 8 * (w / 2) + l % 8, g = l / 8 + 4 * (w % 2);
    if (p0 + n < P)
      wg::cp_async16(stage + (g * kNC + n) * 16,
                     cand_b + (static_cast<long long>(p0) + n) * kC + 8 * g);
  }
}

// The mask byte of candidate p0 + tid (0 past P), read by the first kNC
// threads; `store_mask` packs it as ballot words once it has arrived.
__device__ __forceinline__ unsigned char read_mask(const unsigned char* mask_b, int p0, int P,
                                                   int tid) {
  return tid < kNC && p0 + tid < P ? mask_b[p0 + tid] : 0;
}

__device__ __forceinline__ void store_mask(uint32_t* words, unsigned char m, int tid) {
  if (tid < kNC) {                   // whole warps: kNC % 32 == 0
    const uint32_t bits = __ballot_sync(0xffffffffu, m != 0);
    if (tid % 32 == 0) words[tid / 32] = bits;
  }
}

// Offer (s, idx) to a sorted top-K list; it enters only when strictly
// greater than the last score, and moves up past strictly smaller scores.
template <int K>
__device__ __forceinline__ void offer(float s, int idx, float (&ts)[K], int (&ti)[K]) {
  if (s > ts[K - 1]) {
    ts[K - 1] = s;
    ti[K - 1] = idx;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      if (ts[j] > ts[j - 1]) {
        const float fs = ts[j]; ts[j] = ts[j - 1]; ts[j - 1] = fs;
        const int fi = ti[j]; ti[j] = ti[j - 1]; ti[j - 1] = fi;
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Offer one row's survivors of a tile, in increasing column order: bit j of
// `bits` is this thread's column 8(j/2) + 2(l%4) + j%2 of the tile (p0 =
// the tile's first column + 2(l%4)), whose score is sc[4(j/2) + half +
// j%2] (half 0 for row r, 2 for row r + 8).  The warp loops while any lane
// has one left, so it takes as many rounds as its busiest lane.
template <int K>
__device__ __forceinline__ void offer_survivors(uint32_t bits, const float* sc, int half, int p0,
                                                float (&ts)[K], int (&ti)[K]) {
  while (__any_sync(0xffffffffu, bits != 0)) {
    if (bits != 0) {
      const int j = __ffs(bits) - 1;
      bits &= bits - 1;
      offer<K>(sc[4 * (j >> 1) + half + (j & 1)], p0 + 8 * (j >> 1) + (j & 1), ts, ti);
    }
  }
}

// The quad's four lists of one row merged into its top K (every lane of the
// quad gets all of them): K rounds, each the best head by (score descending,
// index ascending), popped by its owner.  Heads at -1e30 may repeat (index
// 0) across lanes; once one wins, every head is -1e30 and all pop together.
template <int K>
__device__ __forceinline__ void quad_merge(float (&ts)[K], int (&ti)[K], float (&os)[K],
                                           int (&oi)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float s = ts[0];
    int i = ti[0];
#pragma unroll
    for (int m = 1; m <= 2; m *= 2) {
      const float so = __shfl_xor_sync(0xffffffffu, s, m);
      const int io = __shfl_xor_sync(0xffffffffu, i, m);
      if (so > s || (so == s && io < i)) {
        s = so;
        i = io;
      }
    }
    const bool fill = s <= 0.5f * kNeg;       // an empty slot: index 0, score -1e30
    os[j] = fill ? kNeg : s;
    oi[j] = fill ? 0 : i;
    if (ts[0] == s && ti[0] == i) {
#pragma unroll
      for (int t = 0; t < K - 1; ++t) {
        ts[t] = ts[t + 1];
        ti[t] = ti[t + 1];
      }
      ts[K - 1] = kNeg;
      ti[K - 1] = 0;
    }
  }
}

// One query row's outputs: lane qd of the quad writes the slots j % 4 == qd
// and copies its share of every selected value row.
template <int K, bool kGather>
__device__ __forceinline__ void store_row(long long row, const float (&os)[K], const int (&oi)[K],
                                          int qd, const float* __restrict__ values_b,
                                          long long* __restrict__ idx_out,
                                          float* __restrict__ score_out,
                                          float* __restrict__ gathered, int Cv, bool vec) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j % 4 == qd) {
      idx_out[row * K + j] = oi[j];
      score_out[row * K + j] = os[j];
    }
  }
  if constexpr (kGather) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float* src = values_b + static_cast<long long>(oi[j]) * Cv;
      float* dst = gathered + (row * K + j) * Cv;
      if (vec) {
        for (int c = qd; c < Cv / 4; c += 4)
          reinterpret_cast<float4*>(dst)[c] = reinterpret_cast<const float4*>(src)[c];
      } else {
        for (int c = qd; c < Cv; c += 4) dst[c] = src[c];
      }
    }
  }
}

template <int K, bool kGather>
__global__ void __launch_bounds__(kThreads) knn_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cand,
    const unsigned char* __restrict__ mask, const float* __restrict__ values,
    long long* __restrict__ idx_out, float* __restrict__ score_out,
    float* __restrict__ gathered, int N, int P, int Cv) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem + kStages * kTileBytes) + threadIdx.x * kScStride;
  uint32_t* maskw = reinterpret_cast<uint32_t*>(smem + kStages * kTileBytes + kScBytes);
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32, qd = l % 4;
  const int slabs = (N + kM - 1) / kM;
  const int bi = blockIdx.x / slabs, n0 = blockIdx.x % slabs * kM;
  const int r_lo = n0 + 16 * w + l / 4, r_hi = r_lo + 8;
  const __nv_bfloat16* cand_b = cand + static_cast<long long>(bi) * P * kC;
  const unsigned char* mask_b = mask + static_cast<long long>(bi) * P;
  const int tiles = (P + kNC - 1) / kNC;

  // the ring's first kStages - 1 tiles, one commit group each
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      load_tile(smem + s * kTileBytes, cand_b, s * kNC, P, tid);
      store_mask(maskw + s * kMaskWords, read_mask(mask_b, s * kNC, P, tid), tid);
    }
    wg::cp_async_commit();
  }

  // the slab's queries as A fragments: a[c] = rows r, r + 8 at k = 16c +
  // 2(l%4) + {0, 1} and the same + 8 (bf16 pairs, lower k in the low half)
  uint32_t a[kC / 16][4];
  {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(
        q + (static_cast<long long>(bi) * N + min(r_lo, N - 1)) * kC);
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(
        q + (static_cast<long long>(bi) * N + min(r_hi, N - 1)) * kC);
#pragma unroll
    for (int c = 0; c < kC / 16; ++c) {
      a[c][0] = r_lo < N ? lo[8 * c + qd] : 0u;
      a[c][1] = r_hi < N ? hi[8 * c + qd] : 0u;
      a[c][2] = r_lo < N ? lo[8 * c + 4 + qd] : 0u;
      a[c][3] = r_hi < N ? hi[8 * c + 4 + qd] : 0u;
    }
  }

  float ts_lo[K], ts_hi[K];
  int ti_lo[K], ti_hi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ts_lo[j] = ts_hi[j] = kNeg;
    ti_lo[j] = ti_hi[j] = 0;
  }

  float acc[kNC / 2];
  for (int tile = 0; tile < tiles; ++tile) {
    // the tile kStages - 1 ahead goes into the stage the last tile freed
    const int ahead = tile + kStages - 1;
    unsigned char m_ahead = 0;
    if (ahead < tiles) {
      load_tile(smem + (ahead % kStages) * kTileBytes, cand_b, ahead * kNC, P, tid);
      m_ahead = read_mask(mask_b, ahead * kNC, P, tid);
    }
    wg::cp_async_commit();
    wg::cp_async_wait_group<kStages - 1>();      // this tile's copies have landed
    wg::fence_async_shared();                    // ... and are visible to wgmma
    __syncthreads();
    const int stage = tile % kStages;
    const uint32_t base = wg::smem_u32(smem + stage * kTileBytes);
    wg::wgmma_fence();
    wg::fence_operands(acc);
    wg::fence_operands(a);
#pragma unroll
    for (int c = 0; c < kC / 16; ++c)
      wg::Wgmma<kNC>::mma(acc, a[c], wg::kmajor_desc(base + c * 2 * kNC * 16, kNC * 16, 128),
                          c > 0);
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_operands(acc);

    uint32_t mw[kMaskWords];
#pragma unroll
    for (int i = 0; i < kMaskWords; ++i) mw[i] = maskw[stage * kMaskWords + i];
    const int p0 = tile * kNC + 2 * qd;
    if constexpr (K == 1) {
#pragma unroll
      for (int i = 0; i < kNC / 8; ++i) {
        const uint32_t bits = mw[i / 4] >> (8 * (i % 4) + 2 * qd);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (bits >> e) & 1u;
          offer<K>(ok ? acc[4 * i + e] : kNeg, p0 + 8 * i + e, ts_lo, ti_lo);
          offer<K>(ok ? acc[4 * i + 2 + e] : kNeg, p0 + 8 * i + e, ts_hi, ti_hi);
        }
      }
    } else {
      // survivors: valid and not below the quad's highest last score
      // (below it the quad already holds K better); `offer` then takes
      // only those above the thread's own last score
      const float q_lo = quad_max(ts_lo[K - 1]), q_hi = quad_max(ts_hi[K - 1]);
      uint32_t b_lo = 0, b_hi = 0;
#pragma unroll
      for (int i = 0; i < kNC / 8; ++i) {
        const uint32_t bits = mw[i / 4] >> (8 * (i % 4) + 2 * qd);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (bits >> e) & 1u;
          const float s_lo = acc[4 * i + e], s_hi = acc[4 * i + 2 + e];
          b_lo |= static_cast<uint32_t>(ok && s_lo >= q_lo) << (2 * i + e);
          b_hi |= static_cast<uint32_t>(ok && s_hi >= q_hi) << (2 * i + e);
        }
        reinterpret_cast<float4*>(sc)[i] =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      }
      offer_survivors<K>(b_lo, sc, 0, p0, ts_lo, ti_lo);
      offer_survivors<K>(b_hi, sc, 2, p0, ts_hi, ti_hi);
    }
    if (ahead < tiles) store_mask(maskw + (ahead % kStages) * kMaskWords, m_ahead, tid);
    __syncthreads();                         // every warp is done with this stage
  }

  float os[K];
  int oi[K];
  const float* values_b = kGather ? values + static_cast<long long>(bi) * P * Cv : nullptr;
  const bool vec = kGather && Cv % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0;
  quad_merge<K>(ts_lo, ti_lo, os, oi);
  if (r_lo < N)
    store_row<K, kGather>(static_cast<long long>(bi) * N + r_lo, os, oi, qd, values_b, idx_out,
                          score_out, gathered, Cv, vec);
  quad_merge<K>(ts_hi, ti_hi, os, oi);
  if (r_hi < N)
    store_row<K, kGather>(static_cast<long long>(bi) * N + r_hi, os, oi, qd, values_b, idx_out,
                          score_out, gathered, Cv, vec);
}

template <int K, bool kGather>
cudaError_t launch_k(const void* q, const void* cand, const void* mask, const void* values,
                     void* idx, void* score, void* gathered, int B, int N, int P, int Cv,
                     cudaStream_t s) {
  auto kern = knn_wgmma_kernel<K, kGather>;
  static bool configured = false;    // dynamic shared memory above 48 KB, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long grid = static_cast<long long>(B) * ((N + kM - 1) / kM);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(grid), kThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cand),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(values),
      static_cast<long long*>(idx), static_cast<float*>(score), static_cast<float*>(gathered), N,
      P, Cv);
  return cudaGetLastError();
}

template <bool kGather>
cudaError_t launch(const void* q, const void* cand, const void* mask, const void* values,
                   void* idx, void* score, void* gathered, int B, int N, int P, int C, int Cv,
                   int k, cudaStream_t s) {
  if (C != kC || P < 1 || (kGather && Cv < 1)) return cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return cudaSuccess;
  switch (k) {
#define MORIG_KNN_K(KK) \
  case KK: return launch_k<KK, kGather>(q, cand, mask, values, idx, score, gathered, B, N, P, Cv, s)
    MORIG_KNN_K(1);
    MORIG_KNN_K(2);
    MORIG_KNN_K(3);
    MORIG_KNN_K(4);
    MORIG_KNN_K(5);
    MORIG_KNN_K(6);
    MORIG_KNN_K(7);
    MORIG_KNN_K(8);
#undef MORIG_KNN_K
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,N,C) bf16 and cand (B,P,C) bf16, both 16-byte aligned; mask (B,P)
// bool; values (B,P,Cv) fp32; idx (B,N,k) int64, score (B,N,k) fp32,
// gathered (B,N,k,Cv) fp32.  Requires C == 64 (CorrNet's embedding width),
// 1 <= k <= 8, P >= 1 and Cv >= 1.  Returns cudaGetLastError() of the launch.
extern "C" int knn_topk_gather(const void* q, const void* cand, const void* mask,
                               const void* values, void* idx, void* score,
                               void* gathered, int B, int N, int P, int C, int Cv,
                               int k, void* stream) {
  return static_cast<int>(launch<true>(q, cand, mask, values, idx, score, gathered, B, N, P, C,
                                       Cv, k, static_cast<cudaStream_t>(stream)));
}

// K4: the same without values and gathered.
extern "C" int knn_topk(const void* q, const void* cand, const void* mask, void* idx,
                        void* score, int B, int N, int P, int C, int k, void* stream) {
  return static_cast<int>(launch<false>(q, cand, mask, nullptr, idx, score, nullptr, B, N, P, C,
                                        0, k, static_cast<cudaStream_t>(stream)));
}
