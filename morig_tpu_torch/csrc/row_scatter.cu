// The ordered row scatter — a kernel of the port's own for Hopper (sm_90a),
// with no TPU kernel of its own to replace.
//
// out[r] = the sum, in fp32 and in the order of `order`, of the rows
// rows[order[k]] for k in offsets[r] .. offsets[r + 1] - 1: the transpose of a
// row gather (out[r] gets every row whose index is r), given as a reverse
// table built on the card by a stable sort of the flat indices
// (kernels/gather_fused.py `reverse_table`), so each target row adds its
// sources in the order of their flat positions, the same order on every run
// and the order of `index_add_` on the CPU.  It is the card's route of
// `scatter_rows` (the backward of K2's gathers and of the training path's
// row gathers) and the db_table sum of the edge backward K6
// (csrc/edge_mlp_bwd.cu), whose main kernel writes each valid edge's
// bf16(dx) row to a per-edge buffer for it (launched there as
// edge_db_sum_kernel, the same sum under K6's own name), and of KNB
// (csrc/narrow_edge.cu) over its fp32 dx rows (as narrow_db_sum_kernel).  On the TPU neither needs it:
// the JAX package's K6 accumulates db_table in a VMEM block over a grid that
// runs in order, and XLA's scatter-add on a TPU is sequential; on the card
// an atomic scatter adds in an order that changes from run to run.
//
// What bounds it on the H100: the bytes — each source row read once (bf16 or
// fp32), the order and offsets, each output written once.  The design, for
// that bound:
// - Lanes over channels.  A group of G lanes (a power of two, at most a
//   warp) owns one target row; on the vector route each lane owns 16 bytes
//   of its channels (8 bf16 or 4 fp32) and loads them with one 16-byte
//   load, so a warp reads whole 512-byte rows, or several narrow target
//   rows at once.  (The rows are read once, but loads that do not allocate
//   in L1, ld.global.nc.L1::no_allocate, took 0.0123 ms against 0.0095 ms
//   for K6's db_table at H=256 on the H100.)  Rows whose width is not a
//   multiple of 16 bytes, or whose base is not 16-byte aligned, take the
//   scalar route: one channel a lane.  Rows wider than the group are swept
//   in passes of G vectors.
// - The table read once per group: two lanes read offsets[r] and
//   offsets[r + 1], the group reads the next entries of `order` coalesced,
//   one or more a lane, and hands them out with __shfl_sync.  A warp's
//   groups walk their sources in step (warp-wide votes end the loops): a
//   first version whose groups split apart in their loops took 0.0167 ms
//   for K6's db_table at H=128 (two groups a warp) against 0.0121 ms at
//   H=256 (one group, twice the bytes) on the H100.
// - Several rows in flight: the loads of U = 8 source rows are started
//   before their adds, so a lane waits on them at once instead of one by
//   one (U = 4 took 0.0140 ms against 0.0124 at H=256).  The kernels are
//   held to 64 registers, four 256-thread blocks an SM.
// - The sum unchanged: each output channel has one fp32 accumulator from
//   0.0f that takes __fadd_rn of its sources in the table's order; no
//   segment is split across lanes or blocks, no atomics, so the bits are
//   those of `index_add_` on the CPU whatever the route.
// The launch (route, G, block, grid) is kernels/gather_fused.py
// `plan_scatter`'s, a function of the shapes alone, so a CUDA graph can
// capture it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int U = 8;   // source rows a lane loads before it adds them

__device__ __forceinline__ uint4 load16(const void* p) { return *static_cast<const uint4*>(p); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// What one lane loads, adds and stores: 16 bytes of channels (VEC) or one.
template <typename T, bool VEC>
struct Lane;

template <>
struct Lane<float, true> {
  static constexpr int N = 4;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const float* p) { return load16(p); }
  static __device__ __forceinline__ void add(float* acc, const Raw& v) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(v.x));
    acc[1] = __fadd_rn(acc[1], __uint_as_float(v.y));
    acc[2] = __fadd_rn(acc[2], __uint_as_float(v.z));
    acc[3] = __fadd_rn(acc[3], __uint_as_float(v.w));
  }
  static __device__ __forceinline__ void store(float* out, const float* acc) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Lane<__nv_bfloat16, true> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) { return load16(p); }
  // channel 2i is the low half of word i, 2i + 1 the high half; a bf16 is
  // the upper 16 bits of the fp32 of the same value
  static __device__ __forceinline__ void add2(float* acc, uint32_t w) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(w << 16));
    acc[1] = __fadd_rn(acc[1], __uint_as_float(w & 0xffff0000u));
  }
  static __device__ __forceinline__ void add(float* acc, const Raw& v) {
    add2(acc, v.x);
    add2(acc + 2, v.y);
    add2(acc + 4, v.z);
    add2(acc + 6, v.w);
  }
  static __device__ __forceinline__ void store(float* out, const float* acc) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(out + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
};

template <typename T>
struct Lane<T, false> {
  static constexpr int N = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void add(float* acc, const Raw& v) {
    acc[0] = __fadd_rn(acc[0], to_float(v));
  }
  static __device__ __forceinline__ void store(float* out, const float* acc) { out[0] = acc[0]; }
};

// Target row r belongs to the G lanes of global threads r G .. r G + G - 1.
// The warp walks its rows' sources in step: every loop runs while any of
// its groups has a source left, and a group past its own end only idles, so
// the warp never splits into groups that run their loops one after another.
template <typename T, bool VEC, int G>
__device__ __forceinline__ void scatter_rows_in_order(
    const T* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ offsets, float* __restrict__ out, long long R, int C,
    int passes) {
  using L = Lane<T, VEC>;
  constexpr unsigned ALL = 0xffffffffu;
  constexpr int PER = G >= U ? 1 : U / G;   // order entries a lane reads per batch
  constexpr int BATCH = G * PER;            // entries a group reads at once, >= U
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t & ~31LL) / G >= R) return;  // the whole warp
  const int gl = static_cast<int>(t & (G - 1));
  const long long r = t / G;
  const bool live = r < R;
  long long beg = 0, n = 0;          // the group's first entry and its count
  if constexpr (G == 1) {
    if (live) {
      beg = offsets[r];
      n = offsets[r + 1] - beg;
    }
  } else {
    const long long o = live && gl < 2 ? offsets[r + gl] : 0;
    beg = __shfl_sync(ALL, o, 0, G);
    n = __shfl_sync(ALL, o, 1, G) - beg;
  }
  const int nvec = C / L::N;
  for (int p = 0; p < passes; ++p) {
    const int v = p * G + gl;
    const bool mine = live && v < nvec;
    const T* col = rows + static_cast<long long>(v) * L::N;
    float acc[L::N];
#pragma unroll
    for (int i = 0; i < L::N; ++i) acc[i] = 0.f;
    for (long long k0 = 0; __any_sync(ALL, k0 < n); k0 += BATCH) {
      long long e[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const long long k = k0 + gl + q * G;
        e[q] = k < n ? __ldg(order + beg + k) : 0;
      }
      const long long left = n - k0;
      const int cnt = left < 0 ? 0 : left < BATCH ? static_cast<int>(left) : BATCH;
#pragma unroll
      for (int j0 = 0; j0 < BATCH; j0 += U) {
        if (!__any_sync(ALL, j0 < cnt)) break;
        typename L::Raw buf[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u;
          long long s;
          if constexpr (G == 1) s = e[j];
          else s = __shfl_sync(ALL, e[j / G], j % G, G);
          if (j < cnt && mine) buf[u] = L::load(col + s * C);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (j0 + u < cnt && mine) L::add(acc, buf[u]);
      }
    }
    if (mine) L::store(out + r * C + static_cast<long long>(v) * L::N, acc);
  }
}

template <typename T, bool VEC, int G>
__global__ void __launch_bounds__(256, 4) row_scatter_kernel(
    const T* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ offsets, float* __restrict__ out, long long R, int C,
    int passes) {
  scatter_rows_in_order<T, VEC, G>(rows, order, offsets, out, R, C, passes);
}

// The same sum under names of their own, launched for K6's db_table (bf16
// rows) and KNB's (fp32 rows, csrc/narrow_edge.cu), so that a profile tells
// their time from the scatters of `scatter_rows`.
template <bool VEC, int G>
__global__ void __launch_bounds__(256, 4) edge_db_sum_kernel(
    const __nv_bfloat16* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ offsets, float* __restrict__ out, long long R, int C,
    int passes) {
  scatter_rows_in_order<__nv_bfloat16, VEC, G>(rows, order, offsets, out, R, C, passes);
}

template <bool VEC, int G>
__global__ void __launch_bounds__(256, 4) narrow_db_sum_kernel(
    const float* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ offsets, float* __restrict__ out, long long R, int C,
    int passes) {
  scatter_rows_in_order<float, VEC, G>(rows, order, offsets, out, R, C, passes);
}

struct Args {
  const void* rows;
  const long long* order;
  const long long* offsets;
  float* out;
  long long R;
  int C, passes, threads, grid;
  cudaStream_t stream;
};

// edge_db: an edge backward's db_table, K6's (bf16 rows) or KNB's (fp32)
template <typename T, bool VEC, int G>
void launch(const Args& a, bool edge_db) {
  const T* rows = static_cast<const T*>(a.rows);
  if (edge_db) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      edge_db_sum_kernel<VEC, G><<<a.grid, a.threads, 0, a.stream>>>(
          rows, a.order, a.offsets, a.out, a.R, a.C, a.passes);
    else
      narrow_db_sum_kernel<VEC, G><<<a.grid, a.threads, 0, a.stream>>>(
          rows, a.order, a.offsets, a.out, a.R, a.C, a.passes);
    return;
  }
  row_scatter_kernel<T, VEC, G><<<a.grid, a.threads, 0, a.stream>>>(
      rows, a.order, a.offsets, a.out, a.R, a.C, a.passes);
}

// the group widths the planner gives (gather_fused.py `plan_scatter`)
template <typename T, bool VEC>
bool launch_group(const Args& a, bool edge_db, int group) {
  switch (group) {
    case 1: launch<T, VEC, 1>(a, edge_db); return true;
    case 2: launch<T, VEC, 2>(a, edge_db); return true;
    case 4: launch<T, VEC, 4>(a, edge_db); return true;
    case 8: launch<T, VEC, 8>(a, edge_db); return true;
    case 16: launch<T, VEC, 16>(a, edge_db); return true;
    case 32: launch<T, VEC, 32>(a, edge_db); return true;
    default: return false;
  }
}

}  // namespace

// rows (E, C) fp32 (bf16 = 0) or bf16 (bf16 = 1); order (N) int64, entries
// in [0, E); offsets (R + 1) int64, non-decreasing from 0 to at most N;
// out (R, C) fp32.  edge_db = 1 launches the sum under an edge backward's
// name: edge_db_sum_kernel for bf16 rows (K6's db_table),
// narrow_db_sum_kernel for fp32 rows (KNB's).  The plan (gather_fused.py
// `plan_scatter`): vec = 1 for the 16-byte route (C x the element size a
// multiple of 16, rows 16-byte aligned), 0 for the scalar one; group lanes
// per target row; passes over the row's channels; threads per block; grid.
// Writes every row of out (0 where a row has no source).  Returns
// cudaGetLastError() after the launch.
extern "C" int row_scatter(const void* rows, int bf16, int edge_db, const void* order,
                           const void* offsets, void* out, long long R, int C, int vec,
                           int group, int passes, int threads, int grid, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const int esize = bf16 ? 2 : 4;
  const bool bad_vec =
      vec && ((C * esize) % 16 != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0);
  const long long lanes = vec ? C * esize / 16 : C;
  if (bad_vec || threads < 32 || threads > 256 || threads % 32 != 0 ||
      static_cast<long long>(passes) * group < lanes ||
      static_cast<long long>(grid) * threads < R * group)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{rows, static_cast<const long long*>(order), static_cast<const long long*>(offsets),
               static_cast<float*>(out), R, C, passes, threads, grid,
               static_cast<cudaStream_t>(stream)};
  bool ok;
  if (bf16)
    ok = vec ? launch_group<__nv_bfloat16, true>(a, edge_db, group)
             : launch_group<__nv_bfloat16, false>(a, edge_db, group);
  else
    ok = vec ? launch_group<float, true>(a, edge_db, group)
             : launch_group<float, false>(a, edge_db, group);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
