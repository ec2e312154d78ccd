// The count tiles shared by the EQ, TANIMOTO WIDE and MINSUM kernels
// (match_count.cu, tanimoto_count.cu, minsum_count.cu's
// repro_minsum_count_dense):
//
//     counts[q, n] = sum_i count(query[q, i], data[n, i])       int32 [Q, N]
//
// A thread block owns one [128, 128] tile of the output, walks the row axis in
// chunks staged through shared memory, and every thread keeps a register
// micro-tile of accumulators.  Any m streams through the same tile, so the
// TPU's reason for a separate TANIMOTO kernel -- FLASH-scale m does not fit
// VMEM whole -- and the MINSUM kernel's third grid axis do not arise here.
// Ragged edges are masked, so nothing is padded or copied and the output is
// exactly [Q, N].  Two tiles share that frame.
//
// count_eq_tile (namespace eq) -- equality of int32 ids, for EQ and TANIMOTO
// WIDE.  Every id the LSH schemes hand these kernels is a bucket id in
// [0, n_buckets), 8192 by default.  The int16 bit patterns [0, 0x7C00) are
// 31,744 distinct finite float16 values (zero, the subnormals, the normals up
// to 65504), and 0 is the only zero among them, so within that range two ids
// are equal exactly when their float16 patterns compare equal.  Each chunk of
// 32 columns is tested while it is staged (both operands, made uniform across
// the block by __syncthreads_and) and takes one of two paths:
//   - fast (every staged id in [0, 0x7C00)): two neighbouring columns packed
//     into one 32-bit word of float16 lanes, 8-byte shared loads, and per word
//     pair one HSET2.EQ (1.0 or 0.0 per lane) and one HADD2 or HFMA2 into
//     __half2 accumulators; no integer instruction.  Columns past m are quiet
//     NaNs on both sides, which equal nothing.
//   - general (any other id in the chunk: negative, >= 31,744, the ends of
//     int32): one int32 column per slot, one ISETP and an add of 1.0 into the
//     lane of the column's parity, in the same accumulators; exact for every
//     int32.  ptxas turns the predicated add into an HADD2 and a predicated
//     move, so this path costs about 3.4 instructions a pair.
// float16 holds every integer up to 2048 and not 2049, and a lane counts at
// most half the columns it has seen, so the lanes are added into int32 every
// 4096 columns (into the output tile, which each thread owns element by
// element) and once at the end.  Nothing is read back to the host and no
// second launch picks a path.  Two block shapes (eq::Shape), picked by the
// wrapper's tile_q: Wide, [128, 128] output tiles, 512 threads with an 8 x 4
// micro-tile, at most 64 registers so that two blocks share an SM; and
// Narrow, [32, 128] tiles, 256 threads with a 4 x 4 micro-tile, four blocks
// an SM, so that a small query batch does not count 128 query rows a block
// of which only Q are real.
//
// count_tile<P> -- a template on a layout policy P, which says what a
// shared-memory slot holds and how two slots count; only MINSUM's dense tile
// (MinColumns: one int32 column per slot counted by the minimum) uses it now.
// RANGE and packed TANIMOTO, which used it with an (lo, hi) interval and four
// byte lanes per slot, have tiles of their own on the float16 pipe
// (range_count.cu, packed_tanimoto.cu).
//
//     P::Elem                 element type in device memory
//     P::QSlot, P::DSlot      element types of a staged query / data slot
//     P::KS                   slots staged per step
//     P::slots(m)             slots per row of m columns
//     P::stage(dst, ld, src, row0, n_rows, m, s0, rows, query)
//                             stage slots [s0, s0 + KS) of rows [row0, row0 +
//                             rows) at dst[r * ld + s - s0]; slots past
//                             P::slots(m) are staged but never counted
//     P::count(a, b)          what a query slot a and a data slot b add
//
// 256 threads, an 8 x 8 micro-tile of int32 accumulators, one or two integer
// instructions per count.
//
// What bounds them on an H100: the instruction pipes, not memory.  The
// equality count at Q=1024, N=281250, m=238 is 6.85e10 pairs against 0.6 GB
// of traffic.  An SM issues 128 thread-instructions a clock but has 64 INT32
// lanes, so three integer instructions a pair allow ~21 pairs per SM-clock
// (the int32 tile this one replaced ran at 19).  On the fast path the float16
// pipe binds: an HSET2 issues at half the rate of an HADD2 (62 against 112
// thread-instructions per SM-clock, tools/fp16_pipe_rates.py), so a word pair
// takes three issue slots of that pipe and the tile can reach ~86 pairs per
// SM-clock; it runs at ~60, the rest going to staging and the [Q, N] write.
// Measured times and SASS counts are in PERF.md.
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

// One int32 column per slot, counted by the minimum of the two slots:
// sum_v min(query[q, v], data[n, v]) over n-gram multiplicities (MINSUM on
// dense data).
struct MinColumns {
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

  __device__ __forceinline__ static int count(int a, int b) { return min(a, b); }
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

// ---- count_eq_tile: the equality tile ------------------------------------
namespace eq {

// The block shapes of the equality tile: a warp is 32 threads along N with
// four data rows each (128 data rows a block), so that it stores runs of 32
// consecutive counts (128 bytes) of a query row; TY warps along Q with RQ
// query rows each.  Wide, 128 query rows, is the default; Narrow, 32 query
// rows, is for small query batches (a front-end request of Q = 1 to 32
// would otherwise count 128 rows a block, Q of them real).  Both stay within
// 64 registers a thread (two and four blocks an SM).
template <int TY_, int RQ_, int MIN_BLOCKS_>
struct Shape {
  static constexpr int TX = 32;              // threads along N
  static constexpr int TY = TY_;             // threads along Q
  static constexpr int RQ = RQ_;             // query rows per thread
  static constexpr int RN = 4;               // data rows per thread
  static constexpr int TQ = TY * RQ;         // query rows per block
  static constexpr int TN = TX * RN;         // data rows per block
  static constexpr int THREADS = TX * TY;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;   // blocks an SM (__launch_bounds__)
};
using Wide = Shape<16, 8, 2>;                // 128 x 128, 512 threads
using Narrow = Shape<8, 4, 4>;               // 32 x 128, 256 threads

constexpr int KS = 32;                       // columns staged per step
constexpr int KW = KS / 2;                   // words of two float16 lanes per step
constexpr int LDI = KS + 1;                  // int32 rows (general path): conflict-free columns
constexpr int LDW = KW + 2;                  // lane rows (fast path): conflict-free LDS.64
constexpr int FLUSH_CHUNKS = 4096 / KS;      // a lane counts at most 2048 between flushes
constexpr unsigned LANE_END = 0x7C00u;       // ids below it are distinct finite float16s
constexpr int PAD = 0x7E00;                  // a quiet float16 NaN: equals nothing
constexpr unsigned ONE_LO = 0x00003C00u;     // 1.0 in the lane of an even column
constexpr unsigned ONE_HI = 0x3C000000u;     // 1.0 in the lane of an odd column
static_assert(Wide::TQ * KW % Wide::THREADS == 0 && Wide::TN * KW % Wide::THREADS == 0 &&
                  Narrow::TQ * KW % Narrow::THREADS == 0 &&
                  Narrow::TN * KW % Narrow::THREADS == 0,
              "the staging loop covers the chunk");
static_assert(KW % 2 == 0 && LDW % 2 == 0, "8-byte shared loads stay aligned");

// two float16 lanes: 1.0 where they compare equal, else 0.0 (HSET2.BF.EQ)
__device__ __forceinline__ unsigned heq2(unsigned a, unsigned b) {
  unsigned r;
  asm("set.eq.f16x2.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned hadd2(unsigned a, unsigned b) {
  unsigned r;
  asm("add.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// acc += one where a == b: one ISETP, one HADD2
__device__ __forceinline__ void add_if_equal(unsigned& acc, int a, int b, unsigned one) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t@p add.rn.f16x2 %0, %0, %3;\n\t}"
      : "+r"(acc)
      : "r"(a), "r"(b), "r"(one));
}

// the two lanes' counts (each at most 2048, exact) as one int32
__device__ __forceinline__ int lane_sum(unsigned acc) {
  float lo, hi;
  asm("{\n\t.reg .f16 l, h;\n\tmov.b32 {l, h}, %2;\n\tcvt.f32.f16 %0, l;\n\t"
      "cvt.f32.f16 %1, h;\n\t}"
      : "=f"(lo), "=f"(hi)
      : "r"(acc));
  return __float2int_rz(lo + hi);
}

// This thread's column pairs of chunk [s0, s0 + KS) of rows [row0, row0 +
// ROWS): pair p is row threadIdx.x / KW + p * (THREADS / KW), columns s0 +
// 2 w and s0 + 2 w + 1 with w = threadIdx.x % KW, so a warp reads two rows'
// 128-byte segments.  Columns past m and rows past n_rows read as PAD.
template <class S, int ROWS>
struct Pairs {
  static constexpr int P = ROWS * KW / S::THREADS;
  int lo[P], hi[P];

  // load; returns whether every id read lies in [0, LANE_END).  `pairs`:
  // m is even and src 8-byte aligned, so a column pair is one 8-byte load.
  __device__ __forceinline__ bool load(const int* __restrict__ src, long long row0,
                                       long long n_rows, int m, int s0, bool pairs) {
    const int c = s0 + 2 * (threadIdx.x % KW);
    bool in_range = true;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long row = row0 + threadIdx.x / KW + p * (S::THREADS / KW);
      lo[p] = PAD;
      hi[p] = PAD;
      if (row < n_rows && c < m) {
        const int* r = src + row * m + c;
        if (pairs) {
          const int2 v = *reinterpret_cast<const int2*>(r);
          lo[p] = v.x;
          hi[p] = v.y;
        } else {
          lo[p] = r[0];
          if (c + 1 < m) hi[p] = r[1];
        }
        in_range &= (unsigned)lo[p] < LANE_END;
        in_range &= (unsigned)hi[p] < LANE_END || c + 1 >= m;
      }
    }
    return in_range;
  }

  // store as words of two float16 lanes (fast path) or as int32 columns
  __device__ __forceinline__ void store(unsigned* __restrict__ dst, bool lanes) const {
    const int w = threadIdx.x % KW;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int r = threadIdx.x / KW + p * (S::THREADS / KW);
      if (lanes) {
        dst[r * LDW + w] = (unsigned)lo[p] | ((unsigned)hi[p] << 16);
      } else {
        dst[r * LDI + 2 * w] = (unsigned)lo[p];
        dst[r * LDI + 2 * w + 1] = (unsigned)hi[p];
      }
    }
  }
};

// Fast path: words 2 g and 2 g + 1 of every row (4 columns), one 8-byte
// shared load per query row and per data row.
template <class S>
__device__ __forceinline__ void lanes_step(unsigned (&acc)[S::RQ][S::RN],
                                           const unsigned* __restrict__ q_s,
                                           const unsigned* __restrict__ d_s,
                                           int tx, int ty, int g) {
  uint2 dv[S::RN];
#pragma unroll
  for (int j = 0; j < S::RN; ++j)
    dv[j] = *reinterpret_cast<const uint2*>(d_s + (tx + S::TX * j) * LDW + 2 * g);
#pragma unroll
  for (int i = 0; i < S::RQ; ++i) {
    const uint2 qv = *reinterpret_cast<const uint2*>(q_s + (ty + S::TY * i) * LDW + 2 * g);
#pragma unroll
    for (int j = 0; j < S::RN; ++j)
      acc[i][j] = hadd2(hadd2(acc[i][j], heq2(qv.x, dv[j].x)), heq2(qv.y, dv[j].y));
  }
}

// General path: int32 column kk of every row, into the lane of its parity.
template <class S>
__device__ __forceinline__ void ints_step(unsigned (&acc)[S::RQ][S::RN],
                                          const unsigned* __restrict__ q_s,
                                          const unsigned* __restrict__ d_s,
                                          int tx, int ty, int kk) {
  const unsigned one = (kk & 1) ? ONE_HI : ONE_LO;
  int qv[S::RQ], dv[S::RN];
#pragma unroll
  for (int i = 0; i < S::RQ; ++i) qv[i] = (int)q_s[(ty + S::TY * i) * LDI + kk];
#pragma unroll
  for (int j = 0; j < S::RN; ++j) dv[j] = (int)d_s[(tx + S::TX * j) * LDI + kk];
#pragma unroll
  for (int i = 0; i < S::RQ; ++i)
#pragma unroll
    for (int j = 0; j < S::RN; ++j) add_if_equal(acc[i][j], qv[i], dv[j], one);
}

// Add the lanes into the thread's output elements (written on the first
// flush, added to after) and clear them.
template <class S>
__device__ __forceinline__ void flush(unsigned (&acc)[S::RQ][S::RN], int* __restrict__ out,
                                      long long n_data, int n_query, int q0, long long n0,
                                      int tx, int ty, bool add) {
#pragma unroll
  for (int i = 0; i < S::RQ; ++i) {
    const int q = q0 + ty + S::TY * i;
#pragma unroll
    for (int j = 0; j < S::RN; ++j) {
      const long long n = n0 + tx + S::TX * j;
      if (q < n_query && n < n_data) {
        int* o = out + (long long)q * n_data + n;
        *o = (add ? *o : 0) + lane_sum(acc[i][j]);
      }
      acc[i][j] = 0u;
    }
  }
}

// The body of the EQ / TANIMOTO WIDE kernels in block shape S (the first
// argument, a tag: Wide or Narrow), launched with S::THREADS threads per
// block and one block per (query tile, data tile), query tiles fastest
// (launch_eq).
template <class S>
__device__ __forceinline__ void count_eq_tile(S, const int* __restrict__ data,
                                              const int* __restrict__ query,
                                              int* __restrict__ out, long long n_data,
                                              int n_query, int m, int n_qtiles) {
  __shared__ __align__(16) unsigned q_s[S::TQ * LDI];
  __shared__ __align__(16) unsigned d_s[S::TN * LDI];

  const int tx = threadIdx.x % S::TX;
  const int ty = threadIdx.x / S::TX;
  const int q0 = (int)(blockIdx.x % n_qtiles) * S::TQ;
  const long long n0 = (long long)(blockIdx.x / n_qtiles) * S::TN;

  unsigned acc[S::RQ][S::RN];
#pragma unroll
  for (int i = 0; i < S::RQ; ++i)
#pragma unroll
    for (int j = 0; j < S::RN; ++j) acc[i][j] = 0u;

  const bool q_pairs = m % 2 == 0 && reinterpret_cast<size_t>(query) % 8 == 0;
  const bool d_pairs = m % 2 == 0 && reinterpret_cast<size_t>(data) % 8 == 0;
  bool flushed = false;
  int chunk = 0;
  for (int s0 = 0; s0 < m; s0 += KS) {
    const int ks = min(KS, m - s0);
    Pairs<S, S::TQ> qp;
    Pairs<S, S::TN> dp;
    const bool q_in = qp.load(query, q0, n_query, m, s0, q_pairs);
    const bool d_in = dp.load(data, n0, n_data, m, s0, d_pairs);
    // also the barrier after the previous chunk's reads of q_s / d_s
    const bool lanes = __syncthreads_and(q_in && d_in);
    qp.store(q_s, lanes);
    dp.store(d_s, lanes);
    __syncthreads();
    if (lanes) {
      if (ks == KS) {
#pragma unroll
        for (int g = 0; g < KW / 2; ++g) lanes_step<S>(acc, q_s, d_s, tx, ty, g);
      } else {
        for (int g = 0; g < (ks + 3) / 4; ++g) lanes_step<S>(acc, q_s, d_s, tx, ty, g);
      }
    } else {
      if (ks == KS) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ints_step<S>(acc, q_s, d_s, tx, ty, kk);
      } else {
        for (int kk = 0; kk < ks; ++kk) ints_step<S>(acc, q_s, d_s, tx, ty, kk);
      }
    }
    if (++chunk == FLUSH_CHUNKS && s0 + KS < m) {
      flush<S>(acc, out, n_data, n_query, q0, n0, tx, ty, flushed);
      flushed = true;
      chunk = 0;
    }
  }
  flush<S>(acc, out, n_data, n_query, q0, n0, tx, ty, flushed);
}

}  // namespace eq

using eq::count_eq_tile;

// Launch `kernel` over a grid of [tq, tn] output tiles, query tiles fastest,
// with `threads` threads a block, on `stream`; does not synchronise.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when the tile
// grid does not fit one grid dimension.
template <class E>
inline int launch_tiles(void (*kernel)(const E*, const E*, int*, long long, int, int, int),
                        int tq, int tn, int threads, const void* data, const void* query,
                        void* out, long long n_data, int n_query, int m, void* stream) {
  if (n_data <= 0 || n_query <= 0 || m < 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + tq - 1) / tq;
  const long long n_ntiles = (n_data + tn - 1) / tn;
  const long long blocks = n_qtiles * n_ntiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const E*)data, (const E*)query, (int*)out, n_data, n_query, m, (int)n_qtiles);
  return (int)cudaGetLastError();
}

// Launch a __global__ wrapper of count_tile<P> over its tile grid.
template <class P>
inline int launch(void (*kernel)(const typename P::Elem*, const typename P::Elem*,
                                 int*, long long, int, int, int),
                  const void* data, const void* query, void* out,
                  long long n_data, int n_query, int m, void* stream) {
  return launch_tiles(kernel, TQ, TN, THREADS, data, query, out, n_data, n_query, m, stream);
}

// Launch a __global__ wrapper of count_eq_tile<S> over its tile grid.
template <class S>
inline int launch_eq(void (*kernel)(const int*, const int*, int*, long long, int, int, int),
                     const void* data, const void* query, void* out, long long n_data,
                     int n_query, int m, void* stream) {
  return launch_tiles(kernel, S::TQ, S::TN, S::THREADS, data, query, out, n_data, n_query, m,
                      stream);
}

}  // namespace eq_tile
}  // namespace repro
