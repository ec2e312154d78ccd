// The count tile shared by the EQ, TANIMOTO and RANGE kernels and MINSUM's
// dense tile (match_count.cu, tanimoto_count.cu, packed_tanimoto.cu's count
// kernel, range_count.cu, minsum_count.cu's repro_minsum_count_dense):
//
//     counts[q, n] = sum_i count(query[q, i], data[n, i])       int32 [Q, N]
//
// where count is the equality of two signature columns (EQ, TANIMOTO), the
// smaller of two n-gram multiplicities (MINSUM) or the test of an attribute
// value against an interval (RANGE).
//
// A thread block owns one [TQ, TN] tile of the output, walks the row axis in
// chunks of P::KS slots staged through shared memory, and every thread keeps
// an RQ x RN register micro-tile of int32 accumulators (count-and-add, no
// multiply).  Any m streams through the same tile, so the TPU's reason for a
// separate TANIMOTO kernel -- FLASH-scale m (thousands of minhash functions)
// does not fit VMEM whole -- and the MINSUM kernel's third grid axis over the
// vocabulary do not arise here.  Ragged edges are masked (row, column and m
// bounds), so nothing is padded or copied and the output is exactly [Q, N].
//
// The tile is a template on a layout policy P, which says what a shared-memory
// slot holds and how two slots count:
//
//     P::Elem                 element type in device memory
//     P::QSlot, P::DSlot      element types of a staged query / data slot
//     P::KS                   slots staged per step
//     P::slots(m)             slots per row of m columns
//     P::stage(dst, ld, src, row0, n_rows, m, s0, rows, query)
//                             stage slots [s0, s0 + KS) of rows [row0, row0 +
//                             rows) at dst[r * ld + s - s0] (dst is a QSlot*
//                             for the queries, a DSlot* for the data); slots
//                             past P::slots(m) are staged but never counted,
//                             and where a slot holds several columns, those
//                             past m must count nothing across the two sides
//     P::count(a, b)          what a query slot a and a data slot b add
//
// IntColumns below is one int32 column per slot counted by equality (EQ,
// TANIMOTO WIDE); MinColumns the same slots counted by their minimum
// (MINSUM on dense data: sparse n-gram data goes to minsum_count.cu's own
// kernel over lists of its non-zero entries); RangeColumns an int32 (lo, hi) interval per query slot against an
// int32 value per data slot (RANGE); packed_tanimoto.cu holds four uint8 byte
// lanes per slot.
//
// What bounds it on an H100: integer ALU throughput, not memory.  Every output
// element costs m counts and m adds (or a few operations per four lanes);
// at Q=1024, N=281250, m=238 that is 1.4e11 integer operations against 1.4 GB
// of traffic.  Register reuse answers it: each staged slot is counted RQ or
// RN times, so one shared-memory load feeds 8 count-adds, and the block
// index runs over the query tiles first so that the blocks in flight share one
// data tile in L2.  RANGE at d = 14 is the exception: 14 slots per element,
// and the [Q, N] int32 write is its bound.  Measured times are in PERF.md.
#pragma once

#include <cuda_runtime.h>

namespace repro {
namespace eq_tile {

constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along Q
constexpr int RQ = 8;             // query rows per thread
constexpr int RN = 8;             // data rows per thread
constexpr int TQ = TY * RQ;       // 128 query rows per block
constexpr int TN = TX * RN;       // 128 data rows per block
constexpr int THREADS = TX * TY;

// Stage a [rows, KS] window of columns [s0, s0 + KS) of a row-major [n_rows,
// m] matrix of T: a warp reads consecutive columns of one row.  Rows past
// n_rows and columns past m are staged as `fill`; their results are never
// used (the count loop stops at m, the store is masked).
template <int KS, class T>
__device__ __forceinline__ void stage_columns(T* __restrict__ dst, int ld,
                                              const T* __restrict__ src,
                                              long long row0, long long n_rows,
                                              int m, int s0, int rows, T fill) {
  for (int e = threadIdx.x; e < rows * KS; e += THREADS) {
    const int r = e / KS;
    const int c = e % KS;
    const long long row = row0 + r;
    T v = fill;
    if (row < n_rows && s0 + c < m) v = src[row * m + s0 + c];
    dst[r * ld + c] = v;
  }
}

// One int32 signature column per slot, counted by equality.
struct IntColumns {
  using Elem = int;
  using QSlot = int;
  using DSlot = int;
  static constexpr int KS = 32;   // columns staged per step (one 128-byte row segment)

  __device__ static int slots(int m) { return m; }

  __device__ __forceinline__ static void stage(int* __restrict__ dst, int ld,
                                               const int* __restrict__ src,
                                               long long row0, long long n_rows,
                                               int m, int s0, int rows, bool) {
    stage_columns<KS>(dst, ld, src, row0, n_rows, m, s0, rows, 0);
  }

  __device__ __forceinline__ static int count(int a, int b) { return a == b ? 1 : 0; }
};

// The same slots counted by their minimum: sum_v min(query[q, v], data[n, v])
// over n-gram multiplicities (MINSUM).
struct MinColumns : IntColumns {
  __device__ __forceinline__ static int count(int a, int b) { return min(a, b); }
};

// RANGE: a query slot is one attribute's interval (lo, hi), a data slot one
// attribute value, and a slot pair counts [lo <= x <= hi].  The query operand
// is int32 [Q, m, 2] with lo and hi interleaved, the data int32 [N, m].
// KS = 16: a [128, 33] int2 query window and a [128, 33] int window would
// pass the 48 KB of static shared memory a block may hold.
struct RangeColumns {
  using Elem = int;
  using QSlot = int2;
  using DSlot = int;
  static constexpr int KS = 16;   // attributes staged per step (d = 14 in one)

  __device__ static int slots(int m) { return m; }

  // queries: rows past n_rows are staged as the empty interval (1, 0)
  __device__ __forceinline__ static void stage(int2* __restrict__ dst, int ld,
                                               const int* __restrict__ src,
                                               long long row0, long long n_rows,
                                               int m, int s0, int rows, bool) {
    stage_columns<KS>(dst, ld, reinterpret_cast<const int2*>(src), row0, n_rows, m,
                      s0, rows, make_int2(1, 0));
  }

  __device__ __forceinline__ static void stage(int* __restrict__ dst, int ld,
                                               const int* __restrict__ src,
                                               long long row0, long long n_rows,
                                               int m, int s0, int rows, bool) {
    stage_columns<KS>(dst, ld, src, row0, n_rows, m, s0, rows, 0);
  }

  __device__ __forceinline__ static int count(int2 a, int b) {
    return (a.x <= b && b <= a.y) ? 1 : 0;
  }
};

template <class P>
__device__ __forceinline__ void compare_step(int (&acc)[RQ][RN],
                                             const typename P::QSlot* __restrict__ q_s,
                                             const typename P::DSlot* __restrict__ d_s,
                                             int tx, int ty, int kk) {
  constexpr int LD = P::KS + 1;
  typename P::QSlot qv[RQ];
  typename P::DSlot dv[RN];
#pragma unroll
  for (int i = 0; i < RQ; ++i) qv[i] = q_s[(ty + TY * i) * LD + kk];
#pragma unroll
  for (int j = 0; j < RN; ++j) dv[j] = d_s[(tx + TX * j) * LD + kk];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] += P::count(qv[i], dv[j]);
}

// The body of a kernel launched with THREADS threads per block and one block
// per (query tile, data tile), query tiles fastest.
template <class P>
__device__ __forceinline__ void count_tile(const typename P::Elem* __restrict__ data,
                                           const typename P::Elem* __restrict__ query,
                                           int* __restrict__ out,
                                           long long n_data, int n_query,
                                           int m, int n_qtiles) {
  constexpr int KS = P::KS;
  constexpr int LD = KS + 1;      // padded row stride: conflict-free columns
  __shared__ typename P::QSlot q_s[TQ * LD];
  __shared__ typename P::DSlot d_s[TN * LD];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  // query tiles vary fastest: neighbouring blocks reuse one data tile
  const int q0 = (int)(blockIdx.x % n_qtiles) * TQ;
  const long long n0 = (long long)(blockIdx.x / n_qtiles) * TN;

  int acc[RQ][RN];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  const int slots = P::slots(m);
  for (int s0 = 0; s0 < slots; s0 += KS) {
    const int ks = min(KS, slots - s0);
    P::stage(q_s, LD, query, q0, n_query, m, s0, TQ, true);
    P::stage(d_s, LD, data, n0, n_data, m, s0, TN, false);
    __syncthreads();
    if (ks == KS) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) compare_step<P>(acc, q_s, d_s, tx, ty, kk);
    } else {
      for (int kk = 0; kk < ks; ++kk) compare_step<P>(acc, q_s, d_s, tx, ty, kk);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q = q0 + ty + TY * i;
    if (q >= n_query) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const long long n = n0 + tx + TX * j;
      if (n < n_data) out[(long long)q * n_data + n] = acc[i][j];
    }
  }
}

// Launch `kernel` (a __global__ wrapper of count_tile<P>) over the tile grid
// on `stream`; does not synchronise.  Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue when the tile grid does not fit one grid
// dimension.
template <class P>
inline int launch(void (*kernel)(const typename P::Elem*, const typename P::Elem*,
                                 int*, long long, int, int, int),
                  const void* data, const void* query, void* out,
                  long long n_data, int n_query, int m, void* stream) {
  if (n_data <= 0 || n_query <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + TQ - 1) / TQ;
  const long long n_ntiles = (n_data + TN - 1) / TN;
  const long long blocks = n_qtiles * n_ntiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  using E = typename P::Elem;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const E*)data, (const E*)query, (int*)out, n_data, n_query, m,
      (int)n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace eq_tile
}  // namespace repro
