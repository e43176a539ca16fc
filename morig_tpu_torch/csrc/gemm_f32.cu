// The row-invariant fp32 matrix product KG — a kernel of the port's own for
// Hopper (sm_90a), with no TPU kernel of its own to replace.
//
// c[b, m, n] = (bias[n] +) sum over k of a[b, m, k] * b[b, k, n], in fp32,
// each output element summing its K products in one fixed order: acc = 0,
// then acc = fma(a[k], b[k], acc) for k = 0 .. K-1, the bias added last.
// An element's bits therefore depend on its row of a and its column of b
// alone, never on how many rows, columns or batch entries share the call.
// That is what a sharded training step needs: a rank that holds half of the
// batch's rows computes each of them as the one-device step on the whole
// batch does, and a tensor-parallel layer's half of the output columns equals
// those columns of the whole layer.  cuBLAS picks its kernel, tile and
// split-K by shape, so its sums over K change order with M, N and the batch
// count (parallel/steps.py `split_sources` names nn.mlp.Dense's product as
// where a rank's rows first parted on the H100).  On the
// TPU the JAX package leaves its products to XLA, whose rows do not depend
// on the batch either.
//
// Three routes, the same arithmetic per element, so the route (chosen by
// shape) never changes a bit: a 128 x 128 tile per block of 256 threads,
// each holding 8 x 8 sums in registers, where the tiles fill the card; a
// 32 x 64 tile per block of 128 threads (4 x 4 sums each) where they do not
// (a few hundred rows, the global MLPs' batch rows); both stage K through
// shared memory 16 at a time in two buffers, the next step's operands loaded
// into registers while this step's products run.  One thread per output
// element for matrices of at most 64 elements (a masked mean's per-sample
// sum, `kernels/gemm.py` `dot_last`).  No split-K: a block walks all of K,
// which leaves small products with few blocks.  What bounds it on the H100:
// the operations, 2 M N K at 67 TFLOP/s of fp32 without the tensor cores
// (TF32 is off in the port), for all but the smallest products.
#include <cuda_runtime.h>

namespace {

constexpr int BK = 16, PAD = 4;
constexpr int TINY = 64;  // at most this many elements per matrix: one thread per element

// One k step of a thread's TM x TN sums: rows ty*4 + i + h*BM/2 (h < TM/4)
// and columns tx*4 + j + h*BN/2 (h < TN/4), read as float4s.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void tile_step(const float (*As)[BM + PAD],
                                          const float (*Bs)[BN + PAD], int kk, int tx, int ty,
                                          float (&acc)[TM][TN]) {
  float av[TM], bv[TN];
#pragma unroll
  for (int h = 0; h < TM / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(&As[kk][h * (BM / 2) + ty * 4]);
    av[4 * h] = v.x; av[4 * h + 1] = v.y; av[4 * h + 2] = v.z; av[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int h = 0; h < TN / 4; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][h * (BN / 2) + tx * 4]);
    bv[4 * h] = v.x; bv[4 * h + 1] = v.y; bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  static constexpr int LA = BM * BK / THREADS, LB = BN * BK / THREADS;
};

// A BM x BN tile of c per block, K staged through shared memory BK at a
// time in two buffers: the next step's operands are loaded into registers
// while this step's products run.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(Tile<BM, BN, TM, TN>::THREADS) gemm_f32_tiled_kernel(
    const float* __restrict__ a, long long sab, long long sam, long long sak,
    const float* __restrict__ bmat, long long sbb, long long sbk, long long sbn,
    const float* __restrict__ bias, float* __restrict__ c, int batch, int M, int N, int K) {
  using T = Tile<BM, BN, TM, TN>;
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // neighbouring threads read neighbouring addresses along whichever axis
  // of each operand is contiguous
  const bool a_k_fast = sak == 1, b_n_fast = sbn == 1;
  const int steps = (K + BK - 1) / BK;
  for (int bi = blockIdx.z; bi < batch; bi += gridDim.z) {
    const float* A = a + bi * sab;
    const float* B = bmat + bi * sbb;
    float ra[T::LA], rb[T::LB];
    auto load = [&](int k0) {
#pragma unroll
      for (int l = 0; l < T::LA; ++l) {
        const int idx = tid + l * T::THREADS;
        const int r = a_k_fast ? idx / BK : idx % BM, kk = a_k_fast ? idx % BK : idx / BM;
        const int m = m0 + r, k = k0 + kk;
        ra[l] = (m < M && k < K) ? A[m * sam + k * sak] : 0.f;
      }
#pragma unroll
      for (int l = 0; l < T::LB; ++l) {
        const int idx = tid + l * T::THREADS;
        const int cc = b_n_fast ? idx % BN : idx / BK, kk = b_n_fast ? idx / BN : idx % BK;
        const int n = n0 + cc, k = k0 + kk;
        rb[l] = (n < N && k < K) ? B[k * sbk + n * sbn] : 0.f;
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int l = 0; l < T::LA; ++l) {
        const int idx = tid + l * T::THREADS;
        As[buf][a_k_fast ? idx % BK : idx / BM][a_k_fast ? idx / BK : idx % BM] = ra[l];
      }
#pragma unroll
      for (int l = 0; l < T::LB; ++l) {
        const int idx = tid + l * T::THREADS;
        Bs[buf][b_n_fast ? idx / BN : idx % BK][b_n_fast ? idx % BN : idx / BK] = rb[l];
      }
    };
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    if (steps > 0) {
      load(0);
      store(0);
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const int buf = s & 1;
      if (s + 1 < steps) load((s + 1) * BK);
      const int kn = K - s * BK < BK ? K - s * BK : BK;
      if (kn == BK) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          tile_step<BM, BN, TM, TN>(As[buf], Bs[buf], kk, tx, ty, acc);
      } else {
        for (int kk = 0; kk < kn; ++kk)
          tile_step<BM, BN, TM, TN>(As[buf], Bs[buf], kk, tx, ty, acc);
      }
      if (s + 1 < steps) store(buf ^ 1);
      __syncthreads();
    }
    float* C = c + static_cast<long long>(bi) * M * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + (j / 4) * (BN / 2) + tx * 4 + j % 4;
        if (n < N) C[static_cast<long long>(m) * N + n] = bias ? __fadd_rn(acc[i][j], bias[n])
                                                                : acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(256) gemm_f32_small_kernel(
    const float* __restrict__ a, long long sab, long long sam, long long sak,
    const float* __restrict__ bmat, long long sbb, long long sbk, long long sbn,
    const float* __restrict__ bias, float* __restrict__ c, int batch, int M, int N, int K) {
  const long long total = static_cast<long long>(batch) * M * N;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int n = static_cast<int>(i % N);
    const long long t = i / N;
    const int m = static_cast<int>(t % M);
    const long long bi = t / M;
    const float* A = a + bi * sab + m * sam;
    const float* B = bmat + bi * sbb + n * sbn;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(A[k * sak], B[k * sbk], acc);
    c[i] = bias ? __fadd_rn(acc, bias[n]) : acc;
  }
}

template <int BM, int BN, int TM, int TN>
void launch_tiled(const float* a, long long sab, long long sam, long long sak, const float* b,
                  long long sbb, long long sbk, long long sbn, const float* bias, float* c,
                  int batch, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch < 65535 ? batch : 65535);
  gemm_f32_tiled_kernel<BM, BN, TM, TN><<<grid, Tile<BM, BN, TM, TN>::THREADS, 0, s>>>(
      a, sab, sam, sak, b, sbb, sbk, sbn, bias, c, batch, M, N, K);
}

}  // namespace

// a: element (b, m, k) at a[b * sab + m * sam + k * sak]; bmat: element
// (b, k, n) at bmat[b * sbb + k * sbk + n * sbn] (sbb = 0: one matrix for
// the whole batch), both fp32, strides in elements; bias (N) fp32 or null;
// c (batch, M, N) fp32, contiguous.  The route (the 128 x 128 tile where
// it fills the card, the 32 x 64 tile where it does not, one thread per
// element for matrices of at most TINY elements) changes no bit.  Returns
// cudaGetLastError() after the launch.
extern "C" int gemm_f32(const void* a, long long sab, long long sam, long long sak,
                        const void* bmat, long long sbb, long long sbk, long long sbn,
                        const void* bias, void* c, int batch, int M, int N, int K,
                        void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *pa = static_cast<const float*>(a), *pb = static_cast<const float*>(bmat);
  const float* pbias = static_cast<const float*>(bias);
  float* pc = static_cast<float*>(c);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (static_cast<long long>(M) * N <= TINY) {
    const long long want = (static_cast<long long>(batch) * M * N + 255) / 256;
    const int grid = static_cast<int>(want < 32LL * sms ? want : 32LL * sms);
    gemm_f32_small_kernel<<<grid, 256, 0, s>>>(pa, sab, sam, sak, pb, sbb, sbk, sbn, pbias, pc,
                                               batch, M, N, K);
  } else if (static_cast<long long>((M + 127) / 128) * ((N + 127) / 128) * batch >= sms) {
    launch_tiled<128, 128, 8, 8>(pa, sab, sam, sak, pb, sbb, sbk, sbn, pbias, pc, batch, M, N,
                                 K, s);
  } else {
    launch_tiled<32, 64, 4, 4>(pa, sab, sam, sak, pb, sbb, sbk, sbn, pbias, pc, batch, M, N, K,
                               s);
  }
  return static_cast<int>(cudaGetLastError());
}
