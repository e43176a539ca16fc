// The row-invariant fp32 matrix product KG — a kernel of the port's own for
// Hopper (sm_90a).  It replaces no TPU kernel: the JAX package leaves its
// products to XLA, whose rows on a TPU do not depend on the batch.
//
// c[b, m, n] = (bias[n] +) sum over k of a[b, m, k] * b[b, k, n], in fp32.
// Why it exists: cuBLAS picks its kernel, tile and split-K by shape, so its
// sums over K change order with M, N and the batch count, and a rank that
// holds half of a batch's rows (data parallel), or half of a layer's output
// columns (tensor parallel), computed them otherwise than the one-device
// step on the whole batch (parallel/steps.py `split_sources` named
// nn.mlp.Dense's product as where a rank's rows first parted on the H100).
//
// The order.  K is cut into chunks of KC = 64 (one constant, whatever the
// shape).  Chunk c's partial p_c is an fmaf chain from 0.f over k = c KC ..
// min((c + 1) KC, K) - 1 in order; the element is p_0, then
// __fadd_rn(total, p_c) for c = 1, 2, ... in order, then __fadd_rn(total,
// bias[n]).  K = 0 gives 0 (+ bias).  Nothing in that order depends on M, N,
// the batch count or the route, so an element's bits depend on its row of a,
// its column of b and the build alone; and a block that owns chunk c
// computes exactly p_c, so K may be split across blocks.
//
// The routes (kernels/gemm.py `plan` chooses one, its tile and its split,
// from the shape and the SM count; every route computes the order above bit
// for bit, and the card tests force each one on the same products):
//   tile  — a block per BM x BN tile walks all of K and folds its chunks
//           itself: each chunk's partial in registers, the running total
//           per element in shared memory (a thread's own float4s).  The
//           128 x 128 tile (256 threads, 8 x 8 sums each) where a matrix's
//           tiles fill the card: two blocks per SM where they fill it more
//           than once, else one block per SM with three stages and its
//           registers uncapped (8192 x 288 -> 256: 128 tiles); 64 x 64,
//           32 x 64 and 8 x 128 tiles where a batch of small matrices fills
//           the card.
//   split — where the tiles leave SMs idle (a few hundred rows, the global
//           MLPs' batch rows, a masked mean's per-sample sum): blocks own
//           (tile, chunk range) pairs, at least one block per SM where the
//           chunks allow, and write each chunk's partial to a workspace the
//           wrapper allocates; a second kernel adds them in chunk order,
//           then the bias.  The 8 x 128 tile keeps 4 live rows from being
//           padded to 32.
//   tiny  — one thread per element for matrices of at most 256 elements
//           whose sums are one chunk (the temporal attention's per-vertex
//           products, a 48-slot masked mean).
// The tiled kernels stage K through shared memory 16 at a time, k-major
// ([k][row], rows padded by 4 floats).  An operand whose rows are
// contiguous (b of dy @ W) is copied by 16-byte cp.async (8-byte where its
// rows are only 8-byte aligned), a warp reading 512 contiguous bytes; a
// k-fast one (the activations, a Dense weight's W^T view) is read as
// float4s (float2s) along k into registers before a step's products and
// stored transposed after them, a warp's loads covering whole 32-byte
// sectors and its stores 32 banks; an odd K (1891 and 1923, the encoders'
// concatenated features) goes through registers one float at a time.  A
// thread's fragments are float4 reads that its warp shares (a) or that run
// along 256 contiguous bytes (b); the output leaves as float4s with the
// bias added.  The large tile's kernels are compiled apart for the main
// path's layouts, so none carries another's registers.
//
// What bounds it on the H100 (67 TFLOP/s of fp32 FMA without the tensor
// cores, which would need TF32, off in the port; 3.35 TB/s): the
// 8192-row products are bound by the operations (2 M N K), the 4-row ones
// by the bytes of b.  The 128 x 128 tile reads 16 floats of shared memory
// for 64 FMAs, so its FMAs, not its loads, are the limit; it reaches about
// half of the FMA rate (PERF.md).  The split route spreads a few rows'
// bytes of b over every SM.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int KC = 64;   // the chunk of K
constexpr int PAD = 4;   // floats after each staged row of BM or BN (conflict-free transposing stores)
constexpr int FOLD_THREADS = 256, TINY_THREADS = 256;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async with src-size: 0 fills the destination with zeros and reads nothing
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy8(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How an operand's tile reaches shared memory (always as [k][row]): rows
// contiguous and 16- or 8-byte aligned (ROW_FAST16, ROW_FAST8) by cp.async
// of that width; k fast with rows 16- or 8-byte aligned (K_FAST16: K % 4
// == 0; K_FAST8: K % 2 == 0) as float4s or float2s along k through
// registers, stored transposed; otherwise (K_FAST, ROW_FAST) as floats
// through registers.
enum Mode { K_FAST = 0, ROW_FAST = 1, ROW_FAST16 = 2, K_FAST16 = 3, K_FAST8 = 4, ROW_FAST8 = 5 };

// One operand as rows (M of a, N of b) by K: batch entry bi's element
// (r, k) at p[bi * sb + r * sr + k * sk].
struct Operand {
  const float* p;
  long long sb, sr, sk;
  int rows, mode;
};

// A BM x BN tile of c per block of (BN / TN) x (BM / TM) threads, each
// holding TM x TN sums: rows h * (BM / HM) + ty * 4 + v and columns
// h * (BN / HN) + tx * 4 + v (v < 4), read from shared memory as float4s.
// K is staged BK at a time in a ring of STAGES; MINB blocks per SM bound
// the registers.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_, STAGES = STAGES_;
  static constexpr int MINB = MINB_;
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  static constexpr int HM = TM / 4, HN = TN / 4;
  static constexpr int SA = BM + PAD, SB = BN + PAD;   // staged rows' strides, floats
  static constexpr int STAGE = BK * (SA + SB);         // floats per stage
  static constexpr int STAGE_BYTES = STAGES * STAGE * 4;
  static constexpr int TOTAL_BYTES = BM * BN * 4;      // the tile route's running totals
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BK % 8 == 0 && KC % BK == 0, "tile shape");
  static_assert(THREADS % 32 == 0, "whole warps");
  static_assert(SA % 4 == 0 && SB % 4 == 0, "staged rows start 16-byte aligned");
};

// The tiles, in the order of kernels/gemm.py TILES: the large tile at two
// blocks per SM (97.8 KB of shared memory each, 128 registers a thread), the
// small ones, and the large tile at one block per SM (its registers
// uncapped, three stages) for products whose tiles fill the card once.
using TileL = Tile<128, 128, 8, 8, 16, 2, 2>;
using Tile64 = Tile<64, 64, 4, 4, 16, 3, 1>;
using Tile32 = Tile<32, 64, 4, 4, 16, 3, 1>;
using Tile8 = Tile<8, 128, 4, 4, 16, 3, 1>;
using TileL1 = Tile<128, 128, 8, 8, 16, 3, 1>;

// Copy R rows x BK k of a ROW_FAST16 or ROW_FAST8 operand, rows r0.., k
// k0.. (< kend), into dst[BK][R + PAD] by cp.async of 16 or 8 bytes, a warp
// reading 512 or 256 contiguous bytes of one k.
template <int R, int BK, int THREADS, int W>
__device__ __forceinline__ void copy_rows(float* dst, const Operand& op, const float* base,
                                          int r0, int k0, int kend, int tid) {
  constexpr int S = R + PAD, V = R / W, N = BK * V;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    if (N % THREADS != 0 && e >= N) break;
    const int kk = e / V, rr = (e % V) * W, r = r0 + rr, k = k0 + kk;
    const bool ok = r < op.rows && k < kend;
    const float* src = ok ? base + static_cast<long long>(k) * op.sk + r : base;
    if constexpr (W == 4) copy16(dst + kk * S + rr, src, ok);
    else copy8(dst + kk * S + rr, src, ok);
  }
}

// A register-staged operand's R rows x BK k, loaded before a step's
// products and stored into the stage after them, in one register array
// whatever its mode.  K_FAST16: float4s along k, a warp's loads covering RW
// rows x 32 / RW float4s (whole 32-byte sectors) and each of its four
// stores per float4 32 banks (R >= 16).  K_FAST and ROW_FAST: floats, a
// warp taking 4 rows x 8 neighbouring k (a 32-byte sector a row) or 32
// neighbouring rows at one k, its stores in 32 banks.
template <int R, int BK, int THREADS>
struct Staged {
  static constexpr int S = R + PAD;
  static constexpr int RW = R < 16 ? R : 16, KW = 32 / RW;
  static constexpr int NV = R * BK / 4, LOADS4 = (NV + THREADS - 1) / THREADS;
  static constexpr int N2 = R * BK / 2, LOADS2 = (N2 + THREADS - 1) / THREADS;
  static constexpr int N1 = R * BK, LOADS1 = (N1 + THREADS - 1) / THREADS;
  static_assert(NV % 32 == 0 && 32 % RW == 0 && NV / 32 % (R / RW) == 0 &&
                    KW * (NV / 32) / (R / RW) == BK / 4,
                "each float4 of the R x BK tile placed once");
  static_assert(R % 8 == 0 && BK == 16, "a warp's float2s: 8 rows x 4 along k");
  static constexpr int NF = 4 * LOADS4 > 2 * LOADS2 ? 4 * LOADS4 : 2 * LOADS2;
  float v[NF > LOADS1 ? NF : LOADS1];

  __device__ __forceinline__ static void place4(int e, int& r, int& kq) {
    const int p = e % 32, q = e / 32;
    r = (q % (R / RW)) * RW + p % RW;
    kq = p / RW + KW * (q / (R / RW));
  }
  // K_FAST8: a warp loads 8 rows x 4 float2s along k (a 32-byte sector a
  // row), its two stores per float2 in 32 banks
  __device__ __forceinline__ static void place2(int e, int& r, int& kq) {
    const int p = e % 32, q = e / 32;
    r = (q % (R / 8)) * 8 + p % 8;
    kq = p / 8 + 4 * (q / (R / 8));
  }
  __device__ __forceinline__ static void place1(int e, bool row_fast, int& kk, int& rr) {
    kk = row_fast ? e / R : e % 8 + 8 * (e / (8 * R));
    rr = row_fast ? e % R : (e / 8) % R;
  }
  __device__ __forceinline__ void fetch(const Operand& op, const float* base, int r0, int k0,
                                        int kend, int tid) {
    if (op.mode == K_FAST16) {
#pragma unroll
      for (int i = 0; i < LOADS4; ++i) {
        const int e = tid + i * THREADS;
        if (NV % THREADS != 0 && e >= NV) break;
        int r, kq;
        place4(e, r, kq);
        const int k = k0 + 4 * kq;
        const float4 x = r0 + r < op.rows && k < kend
            ? __ldg(reinterpret_cast<const float4*>(base + (r0 + r) * op.sr + k))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
      }
    } else if (op.mode == K_FAST8) {
#pragma unroll
      for (int i = 0; i < LOADS2; ++i) {
        const int e = tid + i * THREADS;
        if (N2 % THREADS != 0 && e >= N2) break;
        int r, kq;
        place2(e, r, kq);
        const int k = k0 + 2 * kq;
        const float2 x = r0 + r < op.rows && k < kend
            ? __ldg(reinterpret_cast<const float2*>(base + static_cast<long long>(r0 + r) * op.sr + k))
            : make_float2(0.f, 0.f);
        v[2 * i] = x.x; v[2 * i + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < LOADS1; ++i) {
        const int e = tid + i * THREADS;
        if (N1 % THREADS != 0 && e >= N1) break;
        int kk, rr;
        place1(e, op.mode == ROW_FAST, kk, rr);
        const int r = r0 + rr, k = k0 + kk;
        v[i] = r < op.rows && k < kend
            ? __ldg(base + static_cast<long long>(r) * op.sr + static_cast<long long>(k) * op.sk)
            : 0.f;
      }
    }
  }
  __device__ __forceinline__ void put(float* dst, const Operand& op, int tid) const {
    if (op.mode == K_FAST16) {
#pragma unroll
      for (int i = 0; i < LOADS4; ++i) {
        const int e = tid + i * THREADS;
        if (NV % THREADS != 0 && e >= NV) break;
        int r, kq;
        place4(e, r, kq);
        float* d = dst + 4 * kq * S + r;
        d[0] = v[4 * i]; d[S] = v[4 * i + 1]; d[2 * S] = v[4 * i + 2]; d[3 * S] = v[4 * i + 3];
      }
    } else if (op.mode == K_FAST8) {
#pragma unroll
      for (int i = 0; i < LOADS2; ++i) {
        const int e = tid + i * THREADS;
        if (N2 % THREADS != 0 && e >= N2) break;
        int r, kq;
        place2(e, r, kq);
        float* d = dst + 2 * kq * S + r;
        d[0] = v[2 * i]; d[S] = v[2 * i + 1];
      }
    } else {
#pragma unroll
      for (int i = 0; i < LOADS1; ++i) {
        const int e = tid + i * THREADS;
        if (N1 % THREADS != 0 && e >= N1) break;
        int kk, rr;
        place1(e, op.mode == ROW_FAST, kk, rr);
        dst[kk * S + rr] = v[i];
      }
    }
  }
};

template <class T>
__device__ __forceinline__ void tile_step(const float* As, const float* Bs, int kk, int tx, int ty,
                                          float (&acc)[T::TM][T::TN]) {
  float av[T::TM], bv[T::TN];
#pragma unroll
  for (int h = 0; h < T::HM; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(As + kk * T::SA + h * (T::BM / T::HM) + ty * 4);
    av[4 * h] = v.x; av[4 * h + 1] = v.y; av[4 * h + 2] = v.z; av[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int h = 0; h < T::HN; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(Bs + kk * T::SB + h * (T::BN / T::HN) + tx * 4);
    bv[4 * h] = v.x; bv[4 * h + 1] = v.y; bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <class T>
__device__ __forceinline__ void zero(float (&acc)[T::TM][T::TN]) {
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
}

// A kernel's AMODE, BMODE: the operands' modes it was compiled for, or ANY
// (read from the operands at run time).
constexpr int ANY = -1;

// The products of k = kb .. ke - 1 (kb a multiple of KC) for the block's
// tile, through a ring of T::STAGES stages; after the last k of each chunk,
// chunk_end(chunk index, whether it is the block's last) reads acc, which
// then starts again from 0.

template <class T, int AMODE, int BMODE, class ChunkEnd>
__device__ __forceinline__ void run_chunks(float* smem, Operand A, Operand B,
                                           const float* Ab, const float* Bb, int m0, int n0,
                                           int kb, int ke, int tid, float (&acc)[T::TM][T::TN],
                                           ChunkEnd&& chunk_end) {
  if (AMODE != ANY) A.mode = AMODE;
  if (BMODE != ANY) B.mode = BMODE;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int steps = (ke - kb + T::BK - 1) / T::BK;
  // ROW_FAST16 and ROW_FAST8 by cp.async into the stage, the other modes
  // through registers: loaded (fetch) before a step's products, stored into
  // the stage (put) after them
  const bool sa = A.mode != ROW_FAST16 && A.mode != ROW_FAST8;
  const bool sb = B.mode != ROW_FAST16 && B.mode != ROW_FAST8;
  Staged<T::BM, T::BK, T::THREADS> ra;
  Staged<T::BN, T::BK, T::THREADS> rb;
  auto copy = [&](int s) {
    float* As = smem + (s % T::STAGES) * T::STAGE;
    const int k0 = kb + s * T::BK;
    float* Bs = As + T::BK * T::SA;
    if (A.mode == ROW_FAST16) copy_rows<T::BM, T::BK, T::THREADS, 4>(As, A, Ab, m0, k0, ke, tid);
    if (A.mode == ROW_FAST8) copy_rows<T::BM, T::BK, T::THREADS, 2>(As, A, Ab, m0, k0, ke, tid);
    if (B.mode == ROW_FAST16) copy_rows<T::BN, T::BK, T::THREADS, 4>(Bs, B, Bb, n0, k0, ke, tid);
    if (B.mode == ROW_FAST8) copy_rows<T::BN, T::BK, T::THREADS, 2>(Bs, B, Bb, n0, k0, ke, tid);
  };
  auto fetch_a = [&](int s) { if (sa) ra.fetch(A, Ab, m0, kb + s * T::BK, ke, tid); };
  auto fetch_b = [&](int s) { if (sb) rb.fetch(B, Bb, n0, kb + s * T::BK, ke, tid); };
  auto put_a = [&](int s) { if (sa) ra.put(smem + (s % T::STAGES) * T::STAGE, A, tid); };
  auto put_b = [&](int s) {
    if (sb) rb.put(smem + (s % T::STAGES) * T::STAGE + T::BK * T::SA, B, tid);
  };
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < steps) {
      copy(s);
      fetch_a(s);
      fetch_b(s);
      put_a(s);
      put_b(s);
    }
    commit_copies();
  }
  for (int s = 0; s < steps; ++s) {
    wait_copies<T::STAGES - 2>();
    __syncthreads();
    // the stage step s + STAGES - 1 takes was last read in step s - 1; its
    // staged operands' loads are in flight while this step's products run
    const int ahead = s + T::STAGES - 1;
    const bool more = ahead < steps;
    if (more) {
      copy(ahead);
      fetch_a(ahead);
      fetch_b(ahead);
    }
    commit_copies();
    const float* As = smem + (s % T::STAGES) * T::STAGE;
    const float* Bs = As + T::BK * T::SA;
    const int k0 = kb + s * T::BK, kn = ke - k0 < T::BK ? ke - k0 : T::BK;
    if (kn == T::BK) {
#pragma unroll
      for (int kk = 0; kk < T::BK; ++kk) tile_step<T>(As, Bs, kk, tx, ty, acc);
    } else {
      for (int kk = 0; kk < kn; ++kk) tile_step<T>(As, Bs, kk, tx, ty, acc);
    }
    if (more) {
      put_a(ahead);
      put_b(ahead);
    }
    const bool last = s == steps - 1;
    if (last || (k0 + T::BK) % KC == 0) {
      chunk_end(k0 / KC, last);
      if (!last) zero<T>(acc);
    }
  }
  wait_copies<0>();
  __syncthreads();
}

// Store a thread's TM x TN values (row i, float4 group g) through f(m, n, v, j).
template <class T, class Store>
__device__ __forceinline__ void for_each_out(int m0, int n0, int tid, Store&& store) {
  const int tx = tid % T::TX, ty = tid / T::TX;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int g = 0; g < T::HN; ++g)
      store(i, g, m0 + (i / 4) * (T::BM / T::HM) + ty * 4 + i % 4,
            n0 + g * (T::BN / T::HN) + tx * 4);
}

__device__ __forceinline__ float4 fadd4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// The tile route: one block per tile and batch entry, all of K.
template <class T, int AMODE, int BMODE>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
    gemm_f32_tile_kernel(Operand A, Operand B, const float* __restrict__ bias,
                         float* __restrict__ c, int batch, int M, int N, int K) {
  extern __shared__ __align__(16) float smem[];
  float4* total = reinterpret_cast<float4*>(smem + T::STAGES * T::STAGE);
  const int tid = threadIdx.x, m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int chunks = (K + KC - 1) / KC;
  const bool vec = N % 4 == 0;
  for (int bi = blockIdx.z; bi < batch; bi += gridDim.z) {
    float acc[T::TM][T::TN];
    zero<T>(acc);
    run_chunks<T, AMODE, BMODE>(smem, A, B, A.p + bi * A.sb, B.p + bi * B.sb, m0, n0, 0, K, tid, acc,
                  [&](int chunk, bool last) {
                    if (last) return;   // the last chunk's partial stays in acc
#pragma unroll
                    for (int i = 0; i < T::TM; ++i)
#pragma unroll
                      for (int g = 0; g < T::HN; ++g) {
                        float4& t = total[(i * T::HN + g) * T::THREADS + tid];
                        const float4 p = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                                     acc[i][4 * g + 2], acc[i][4 * g + 3]);
                        t = chunk == 0 ? p : fadd4(t, p);
                      }
                  });
    float* C = c + static_cast<long long>(bi) * M * N;
    for_each_out<T>(m0, n0, tid, [&](int i, int g, int m, int n) {
      float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                             acc[i][4 * g + 3]);
      if (chunks >= 2) v = fadd4(total[(i * T::HN + g) * T::THREADS + tid], v);
      if (m >= M) return;
      float o[4] = {v.x, v.y, v.z, v.w};
      if (bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) o[j] = __fadd_rn(o[j], bias[n + j]);
      }
      float* row = C + static_cast<long long>(m) * N;
      if (vec && n < N) {
        *reinterpret_cast<float4*>(row + n) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = o[j];
      }
    });
  }
}

// The split route's first pass: block (tile, z) with z = bi * splits + s
// owns chunks s * per .. of batch entry bi and writes each chunk's partial
// to ws[bi][chunk][M][N].
template <class T, int AMODE, int BMODE>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
    gemm_f32_split_kernel(Operand A, Operand B, float* __restrict__ ws, int batch, int M, int N,
                          int K, int per, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int chunks = (K + KC - 1) / KC;
  const bool vec = N % 4 == 0;
  const long long mn = static_cast<long long>(M) * N;
  for (long long z = blockIdx.z; z < static_cast<long long>(batch) * splits; z += gridDim.z) {
    const int bi = static_cast<int>(z / splits), s = static_cast<int>(z % splits);
    const int c0 = s * per, kb = c0 * KC;
    const int ke = (c0 + per) * KC < K ? (c0 + per) * KC : K;
    float acc[T::TM][T::TN];
    zero<T>(acc);
    run_chunks<T, AMODE, BMODE>(smem, A, B, A.p + bi * A.sb, B.p + bi * B.sb, m0, n0, kb, ke, tid, acc,
                  [&](int chunk, bool) {
                    float* P = ws + (static_cast<long long>(bi) * chunks + chunk) * mn;
                    for_each_out<T>(m0, n0, tid, [&](int i, int g, int m, int n) {
                      if (m >= M) return;
                      float* row = P + static_cast<long long>(m) * N;
                      if (vec && n < N) {
                        *reinterpret_cast<float4*>(row + n) =
                            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                                        acc[i][4 * g + 3]);
                      } else {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                          if (n + j < N) row[n + j] = acc[i][4 * g + j];
                      }
                    });
                  });
  }
}

// The split route's second pass: each element's partials folded in chunk
// order, then the bias.
__global__ void __launch_bounds__(FOLD_THREADS)
    gemm_f32_fold_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                         float* __restrict__ c, int batch, int M, int N, int chunks) {
  const long long mn = static_cast<long long>(M) * N, count = batch * mn;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const long long bi = i / mn, e = i % mn;
    const float* p = ws + bi * chunks * mn + e;
    float t = chunks > 0 ? p[0] : 0.f;
    for (int q = 1; q < chunks; ++q) t = __fadd_rn(t, p[q * mn]);
    c[i] = bias ? __fadd_rn(t, bias[e % N]) : t;
  }
}

// The tiny route: one thread per element, its chunks in order.
__global__ void __launch_bounds__(TINY_THREADS)
    gemm_f32_tiny_kernel(const float* __restrict__ a, long long sab, long long sam, long long sak,
                         const float* __restrict__ bmat, long long sbb, long long sbk,
                         long long sbn, const float* __restrict__ bias, float* __restrict__ c,
                         int batch, int M, int N, int K) {
  const long long count = static_cast<long long>(batch) * M * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const int n = static_cast<int>(i % N);
    const long long t = i / N;
    const int m = static_cast<int>(t % M);
    const long long bi = t / M;
    const float* Ar = a + bi * sab + m * sam;
    const float* Bc = bmat + bi * sbb + n * sbn;
    float total = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int k1 = k0 + KC < K ? k0 + KC : K;
      float p = 0.f;
      for (int k = k0; k < k1; ++k) p = fmaf(Ar[k * sak], Bc[k * sbk], p);
      total = k0 == 0 ? p : __fadd_rn(total, p);
    }
    c[i] = bias ? __fadd_rn(total, bias[n]) : total;
  }
}

Operand operand(const float* p, long long sb, long long sr, long long sk, int rows, int K) {
  // the widest vectors along whichever axis is contiguous that lie whole in
  // range and aligned: 16 bytes, else 8, else 4
  const bool row_fast = sr == 1 && (rows > 1 || sk != 1);
  const auto width = [&](long long extent, long long stride) {
    const std::uintptr_t a = reinterpret_cast<std::uintptr_t>(p);
    for (int w : {4, 2})
      if (a % (4 * w) == 0 && sb % w == 0 && extent % w == 0 && stride % w == 0) return w;
    return 1;
  };
  if (row_fast) {
    const int w = width(rows, sk);
    return {p, sb, sr, sk, rows, w == 4 ? ROW_FAST16 : w == 2 ? ROW_FAST8 : ROW_FAST};
  }
  const int w = sk == 1 ? width(K, rows == 1 ? 4 : sr) : 1;
  return {p, sb, sr, sk, rows, w == 4 ? K_FAST16 : w == 2 ? K_FAST8 : K_FAST};
}

// A kernel's shared memory above 48 KB, allowed once per device (`allowed`:
// the kernel's own flags, one per device).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&allowed)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && allowed[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

template <class T, int AMODE, int BMODE>
cudaError_t launch_tile_as(const Operand& A, const Operand& B, const float* bias, float* c,
                           int batch, int M, int N, int K, dim3 grid, cudaStream_t s) {
  static bool allowed[64] = {};
  const int bytes = T::STAGE_BYTES + T::TOTAL_BYTES;
  const cudaError_t err = allow_smem(gemm_f32_tile_kernel<T, AMODE, BMODE>, bytes, allowed);
  if (err != cudaSuccess) return err;
  gemm_f32_tile_kernel<T, AMODE, BMODE><<<grid, T::THREADS, bytes, s>>>(A, B, bias, c, batch, M, N, K);
  return cudaSuccess;
}

// The large tiles compiled apart for the main path's layouts, so none
// carries another's registers: a Dense forward (both operands k-fast) and
// its input gradient (b n-fast), K a multiple of 4 or of 2 (the motion
// encoders' 1862 features); where K is odd (1891, 1923) the same at one
// block per SM (the host sends such operands to TileL1).
template <class T>
cudaError_t launch_tile(const Operand& A, const Operand& B, const float* bias, float* c,
                        int batch, int M, int N, int K, dim3 grid, cudaStream_t s) {
  if constexpr (T::BM == 128) {
    if (A.mode == K_FAST16 && B.mode == K_FAST16)
      return launch_tile_as<T, K_FAST16, K_FAST16>(A, B, bias, c, batch, M, N, K, grid, s);
    if (A.mode == K_FAST16 && B.mode == ROW_FAST16)
      return launch_tile_as<T, K_FAST16, ROW_FAST16>(A, B, bias, c, batch, M, N, K, grid, s);
    if (A.mode == K_FAST8 && B.mode == K_FAST8)
      return launch_tile_as<T, K_FAST8, K_FAST8>(A, B, bias, c, batch, M, N, K, grid, s);
    if (A.mode == K_FAST16 && B.mode == ROW_FAST8)
      return launch_tile_as<T, K_FAST16, ROW_FAST8>(A, B, bias, c, batch, M, N, K, grid, s);
  }
  if constexpr (T::BM == 128 && T::MINB == 1) {
    if (A.mode == K_FAST && B.mode == K_FAST)
      return launch_tile_as<T, K_FAST, K_FAST>(A, B, bias, c, batch, M, N, K, grid, s);
    if (A.mode == K_FAST16 && B.mode == ROW_FAST)
      return launch_tile_as<T, K_FAST16, ROW_FAST>(A, B, bias, c, batch, M, N, K, grid, s);
  }
  return launch_tile_as<T, ANY, ANY>(A, B, bias, c, batch, M, N, K, grid, s);
}

template <class T, int AMODE, int BMODE>
cudaError_t launch_split_as(const Operand& A, const Operand& B, float* ws, int batch, int M,
                            int N, int K, int per, int splits, dim3 grid, cudaStream_t s) {
  static bool allowed[64] = {};
  const cudaError_t err =
      allow_smem(gemm_f32_split_kernel<T, AMODE, BMODE>, T::STAGE_BYTES, allowed);
  if (err != cudaSuccess) return err;
  gemm_f32_split_kernel<T, AMODE, BMODE><<<grid, T::THREADS, T::STAGE_BYTES, s>>>(
      A, B, ws, batch, M, N, K, per, splits);
  return cudaSuccess;
}

// The split route compiled apart for a Dense forward and its input
// gradient with float4-aligned operands, the main path's few-row products.
template <class T>
cudaError_t launch_split(const Operand& A, const Operand& B, float* ws, int batch, int M, int N,
                         int K, int per, int splits, dim3 grid, cudaStream_t s) {
  if constexpr (T::BM < 128) {   // the large tiles split only where tests force them
    if (A.mode == K_FAST16 && B.mode == K_FAST16)
      return launch_split_as<T, K_FAST16, K_FAST16>(A, B, ws, batch, M, N, K, per, splits, grid,
                                                     s);
    if (A.mode == K_FAST16 && B.mode == ROW_FAST16)
      return launch_split_as<T, K_FAST16, ROW_FAST16>(A, B, ws, batch, M, N, K, per, splits,
                                                       grid, s);
  }
  return launch_split_as<T, ANY, ANY>(A, B, ws, batch, M, N, K, per, splits, grid, s);
}

}  // namespace

// a: element (b, m, k) at a[b * sab + m * sam + k * sak]; bmat: element
// (b, k, n) at bmat[b * sbb + k * sbk + n * sbn] (sbb = 0: one matrix for
// the whole batch), both fp32, strides in elements; bias (N) fp32 or null;
// c (batch, M, N) fp32, contiguous; ws the split route's workspace (batch x
// chunks x M x N fp32) or null.  The plan (kernels/gemm.py `plan`): route 0
// tiny, 1 tile, 2 split; tile an index of TILES; per chunks per block and
// splits blocks per tile of the split route; the grid of the tile or split
// kernel and the fold's blocks.  Returns cudaGetLastError() after the
// launches (or the first error met).
extern "C" int gemm_f32(const void* a, long long sab, long long sam, long long sak,
                        const void* bmat, long long sbb, long long sbk, long long sbn,
                        const void* bias, void* c, void* ws, int batch, int M, int N, int K,
                        int route, int tile, int per, int splits, int gx, int gy, int gz,
                        int fold_blocks, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (K < 0 || route < 0 || route > 2 || tile < 0 || tile > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *pa = static_cast<const float*>(a), *pb = static_cast<const float*>(bmat);
  const float* pbias = static_cast<const float*>(bias);
  float* pc = static_cast<float*>(c);
  if (route == 0) {
    gemm_f32_tiny_kernel<<<gx, TINY_THREADS, 0, s>>>(pa, sab, sam, sak, pb, sbb, sbk, sbn, pbias,
                                                     pc, batch, M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const Operand A = operand(pa, sab, sam, sak, M, K), B = operand(pb, sbb, sbn, sbk, N, K);
  const dim3 grid(gx, gy, gz);
  cudaError_t err = cudaSuccess;
  if (route == 1) {
    // operands loaded a float at a time need the registers that two blocks
    // per SM lack: the large tile at one block per SM (the same bits)
    if (tile == 0 && (A.mode <= ROW_FAST || B.mode <= ROW_FAST)) tile = 4;
    switch (tile) {
      case 0: err = launch_tile<TileL>(A, B, pbias, pc, batch, M, N, K, grid, s); break;
      case 1: err = launch_tile<Tile64>(A, B, pbias, pc, batch, M, N, K, grid, s); break;
      case 2: err = launch_tile<Tile32>(A, B, pbias, pc, batch, M, N, K, grid, s); break;
      case 3: err = launch_tile<Tile8>(A, B, pbias, pc, batch, M, N, K, grid, s); break;
      default: err = launch_tile<TileL1>(A, B, pbias, pc, batch, M, N, K, grid, s); break;
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  float* pws = static_cast<float*>(ws);
  if (splits > 0 && gz > 0) {
    switch (tile) {
      case 0: err = launch_split<TileL>(A, B, pws, batch, M, N, K, per, splits, grid, s); break;
      case 1: err = launch_split<Tile64>(A, B, pws, batch, M, N, K, per, splits, grid, s); break;
      case 2: err = launch_split<Tile32>(A, B, pws, batch, M, N, K, per, splits, grid, s); break;
      case 3: err = launch_split<Tile8>(A, B, pws, batch, M, N, K, per, splits, grid, s); break;
      default: err = launch_split<TileL1>(A, B, pws, batch, M, N, K, per, splits, grid, s); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gemm_f32_fold_kernel<<<fold_blocks, FOLD_THREADS, 0, s>>>(pws, pbias, pc, batch, M, N,
                                                            (K + KC - 1) / KC);
  return static_cast<int>(cudaGetLastError());
}
