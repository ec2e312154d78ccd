// RANGE match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_d [lo[q, d] <= data[n, d] <= hi[q, d]]   int32 [Q, N]
//
// over discretised tuples int32 [N, d] and per-attribute query intervals lo,
// hi int32 [Q, d].  An empty interval (lo > hi) counts nothing; values may be
// anything int32 can hold, INT32_MIN / INT32_MAX included (the engine pads
// data rows with INT32_MIN, below any lo).
//
// Replaces the TPU kernel `_range_count_kernel` / `range_count_pallas`
// (src/repro/kernels/range_count.py), which holds a [128, d] pair of lo / hi
// blocks and a [256, d] data block in VMEM and folds d on the vector unit; its
// wrapper pads queries with the empty range lo = 1, hi = 0 and data with -1.
//
// What bounds it on an H100: the count write.  At Adult's per-segment shape
// (Q = 1024, N = 61,250, d = 14) the [Q, N] int32 output is 251 MB, 0.075 ms
// at the memory rate, while the Q*N*d = 8.8e8 interval tests take 0.039 ms
// on the float16 pipe below (three single-slot instructions per two tests,
// ~75 tests per SM-clock at the measured rate of those instructions) and 0.16
// ms on the 64-lane integer pipe (two compares and an add per test, ~21 tests
// per SM-clock).  So the tests run on the float16 pipe.  Measured on an H100
// 80GB HBM3 at 700 W: 0.14 ms at that shape, 54 % of the bytes bound, its
// tests alone 0.107 ms and its stores alone 0.106 ms (PERF.md):
//
//   - The frame of the equality tile (eq_tile.cuh): a block of 512 threads
//     owns a [128 queries, 128 data rows] tile of the output, stages 16
//     attributes of both sides per step (Adult's d = 14 in one) and keeps a
//     register micro-tile of 8 query rows by 4 data rows, the data rows 32
//     apart, so that a warp stores each row of its counts as 4 runs of 32
//     consecutive ints; two blocks share an SM, so one block's stores overlap
//     the other's tests.
//   - A word holds two attributes of one row as two float16 lanes, as the
//     equality tile holds two columns: a staged query word then carries two
//     intervals, so the shared-memory reads per test are half those of one
//     attribute a word.  The data are staged transposed, so a warp reads a
//     word of 32 consecutive rows with one conflict-free 4-byte load.
//   - lo and hi arrive as two operands and are interleaved as the block stages
//     them: nothing is copied on the host.
//
// The tests.  A chunk of attributes is staged as float16 when every data
// value staged for it lies in [-2048, 2048] (all Adult's values do: bins in
// [0, 1024)), decided per block with __syncthreads_and; any other chunk takes
// the int32 path in the same launch.  On the float16 path a query bound is
// replaced by one that gives the same test for every x in [-2048, 2048] and
// keeps the offsets below exact float16 integers (those in [-2048, 2048], and
// the even ones beyond): lo' = -2049 where lo <= -2048, else min(lo, 2049);
// hi' = 2049 where hi >= 2048, else max(hi, -2049).  They are staged as c_lo
// = 1 - lo' in [-2048, 2048] or 2050, and c_hi = hi' + 1 likewise.  Per word:
//
//     a = sat(x + c_lo)     (add.sat.f16x2: 1 where x >= lo', else 0)
//     b = sat(c_hi - x)     (sub.sat.f16x2: 1 where x <= hi', else 0)
//     acc = a * b + acc     (fma.f16x2)
//
// exact: x - lo' + 1 is an integer in [-4096, 4098], float16 rounds such an
// integer to an integer (2048 to 4098 to an even one) and keeps its sign, so
// the rounded sum is >= 1 exactly when x >= lo' and <= 0 otherwise, and sat()
// makes it 1 or 0; likewise for hi'.  The int32 path tests lo <= x && x <= hi
// (two ISETPs) and adds 1.0 into the lane of the attribute's parity with a
// predicated HADD2, exact for every int32.  An empty interval (lo > hi) counts
// nothing on both paths: no x is both >= lo and <= hi, and lo', hi' give the
// same tests for every x the float16 path takes.  Attributes past d (the odd
// lane of the last word, the rest of the last chunk) and query rows past Q
// are staged as data 0 against the empty interval (1, 0), which counts
// nothing; counts of query rows past Q are never stored.
//
// A chunk counts at most 16 attributes, 8 in a lane, and a lane's count k
// comes out of its float16 value by a multiplication by 2^-24 (mul.f16x2),
// which makes its bit pattern equal k (the subnormals and the first binade of
// float16 are 2^-24 apart): the count of a word is the sum of its two lanes'
// bits.  Where d > 16 each chunk's counts are added into the output, which
// each thread owns element by element.  Measured times and SASS counts are in
// PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;                 // 16 warps
constexpr int WARPS = THREADS / 32;
constexpr int RQ = 8;                        // query rows per warp (and per thread)
constexpr int TQ = WARPS * RQ;               // 128 query rows per block
constexpr int RN = 4;                        // data rows per thread, 32 apart
constexpr int TN = 32 * RN;                  // 128 data rows per block
constexpr int KD = 16;                       // attributes staged per step
constexpr int KW = KD / 2;                   // words of two attributes per step
constexpr int LDD = TN + 4;                  // words (ints) per staged data word (attribute)
constexpr int LANE_MAX = 2048;               // data values in [-2048, 2048] are exact float16
constexpr int CLAMP = 2049;                  // query bounds moved into [-2049, 2049]
constexpr unsigned EPS2 = 0x00010001u;       // 2^-24 in both lanes
constexpr unsigned ONE_LO = 0x00003C00u;     // 1.0 in the lane of an even attribute
constexpr unsigned ONE_HI = 0x3C000000u;     // ... of an odd one
constexpr int STAGE = TN * KW / THREADS;     // words a thread stages a side per step
constexpr int QSTAGE = TQ * KW / THREADS;    // query words a thread stages per step
static_assert(TN * KW % THREADS == 0 && TQ * KW % THREADS == 0, "the staging covers a step");

// float(v) for |v| < 2^22 on the float32 pipe (no conversion instruction)
__device__ __forceinline__ float exact_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}

// integers lo, hi that float16 holds exactly as the two lanes of a word
__device__ __forceinline__ unsigned half2_of(int lo, int hi) {
  unsigned r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(exact_float(hi)), "f"(exact_float(lo)));
  return r;
}

// acc += [x >= lo'] * [x <= hi'] in each lane (the float16 path)
__device__ __forceinline__ void test2(unsigned& acc, unsigned x, unsigned c_lo, unsigned c_hi) {
  asm("{\n\t.reg .b32 a, b;\n\tadd.rn.sat.f16x2 a, %1, %2;\n\t"
      "sub.rn.sat.f16x2 b, %3, %1;\n\tfma.rn.f16x2 %0, a, b, %0;\n\t}"
      : "+r"(acc)
      : "r"(x), "r"(c_lo), "r"(c_hi));
}

// acc += one where lo <= x <= hi (the int32 path)
__device__ __forceinline__ void test1(unsigned& acc, int x, int lo, int hi, unsigned one) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.s32 p, %1, %2;\n\tsetp.le.and.s32 p, %2, %3, p;\n\t"
      "@p add.rn.f16x2 %0, %0, %4;\n\t}"
      : "+r"(acc)
      : "r"(lo), "r"(x), "r"(hi), "r"(one));
}

// the count of a word of two lanes: their bits after a multiplication by 2^-24
__device__ __forceinline__ int lane_sum(unsigned acc) {
  unsigned r;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(acc), "r"(EPS2));
  return (int)((r & 0xFFFFu) + (r >> 16));
}

// A thread's staged words of one step: word e % KW (attributes 2 (e % KW) and
// one more) of row e / KW, for e = threadIdx.x + THREADS * p.
struct Words {
  int x[STAGE][2];

  // data rows [n0, n0 + TN); returns whether every value read lies in
  // [-2048, 2048]
  __device__ __forceinline__ bool load(const int* __restrict__ src, long long n0,
                                       long long n_rows, int d, int s0, int ks) {
    bool in = true;
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = threadIdx.x + THREADS * p;
      const long long row = n0 + e / KW;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 2 * (e % KW) + h;            // attributes past ks and rows past the end: 0
        x[p][h] = row < n_rows && a < ks ? src[row * d + s0 + a] : 0;
        in &= x[p][h] >= -LANE_MAX && x[p][h] <= LANE_MAX;
      }
    }
    return in;
  }

  // transposed: word w of row r at d_s[w * LDD + r] (float16 lanes), or
  // attribute a of row r at d_s[a * LDD + r] (int32)
  __device__ __forceinline__ void store(int* __restrict__ d_s, bool lanes) const {
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = threadIdx.x + THREADS * p;
      const int w = e % KW, r = e / KW;
      if (lanes) {
        d_s[w * LDD + r] = (int)half2_of(x[p][0], x[p][1]);
      } else {
        d_s[2 * w * LDD + r] = x[p][0];
        d_s[(2 * w + 1) * LDD + r] = x[p][1];
      }
    }
  }
};

// A thread's staged query words of one step: the intervals of attributes
// 2w, 2w + 1 (w = e % KW) of query row q0 + e / KW, for e = threadIdx.x +
// THREADS * p; attributes past ks and rows past n_query as the empty interval
// (1, 0).  Loaded with the data words, so that one wait covers both.
struct QueryWords {
  int2 b[QSTAGE][2];

  __device__ __forceinline__ void load(const int* __restrict__ lo, const int* __restrict__ hi,
                                       int q0, int n_query, int d, int s0, int ks) {
#pragma unroll
    for (int p = 0; p < QSTAGE; ++p) {
      const int e = threadIdx.x + THREADS * p;
      const int w = e % KW, q = q0 + e / KW;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 2 * w + h;
        b[p][h] = make_int2(1, 0);
        if (q < n_query && a < ks) {
          const long long at = (long long)q * d + s0 + a;
          b[p][h] = make_int2(lo[at], hi[at]);
        }
      }
    }
  }

  // q_h[w][r] = (c_lo, c_hi) words of attributes 2w, 2w + 1; q_i[a][r] = (lo, hi)
  __device__ __forceinline__ void store(uint2* __restrict__ q_h, int2* __restrict__ q_i) const {
#pragma unroll
    for (int p = 0; p < QSTAGE; ++p) {
      const int e = threadIdx.x + THREADS * p;
      const int w = e % KW, r = e / KW;
      int c[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = b[p][h].x, u = b[p][h].y;
        q_i[(2 * w + h) * TQ + r] = b[p][h];
        // -2048 <= x: lo = -2048 tests as lo = -2049, whose offset 2050 is exact
        c[h][0] = 1 - (l <= -LANE_MAX ? -CLAMP : min(l, CLAMP));
        c[h][1] = (u >= LANE_MAX ? CLAMP : max(u, -CLAMP)) + 1;
      }
      q_h[w * TQ + r] = make_uint2(half2_of(c[0][0], c[1][0]), half2_of(c[0][1], c[1][1]));
    }
  }
};

// Word w of the staged chunk against the warp's 8 query rows.
__device__ __forceinline__ void lanes_step(unsigned (&acc)[RQ][RN], const int* __restrict__ d_s,
                                           const uint2* __restrict__ q_h, int warp, int lane,
                                           int w) {
  unsigned x[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) x[j] = (unsigned)d_s[w * LDD + lane + 32 * j];
  const uint4* q = reinterpret_cast<const uint4*>(q_h + w * TQ + RQ * warp);
#pragma unroll
  for (int i = 0; i < RQ; i += 2) {
    const uint4 c = q[i / 2];                // (c_lo, c_hi) of query rows i and i + 1
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      test2(acc[i][j], x[j], c.x, c.y);
      test2(acc[i + 1][j], x[j], c.z, c.w);
    }
  }
}

// Attribute a of the staged chunk (int32) against the warp's 8 query rows.
__device__ __forceinline__ void ints_step(unsigned (&acc)[RQ][RN], const int* __restrict__ d_s,
                                          const int2* __restrict__ q_i, int warp, int lane,
                                          int a) {
  int x[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) x[j] = d_s[a * LDD + lane + 32 * j];
  const int4* q = reinterpret_cast<const int4*>(q_i + a * TQ + RQ * warp);
  const unsigned one = (a & 1) ? ONE_HI : ONE_LO;
#pragma unroll
  for (int i = 0; i < RQ; i += 2) {
    const int4 c = q[i / 2];                 // (lo, hi) of query rows i and i + 1
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      test1(acc[i][j], x[j], c.x, c.y, one);
      test1(acc[i + 1][j], x[j], c.z, c.w, one);
    }
  }
}

// two blocks per SM (at most 64 registers a thread); one block per (query
// tile, data tile), query tiles fastest
__global__ void __launch_bounds__(THREADS, 2)
range_count_kernel(const int* __restrict__ data, const int* __restrict__ lo,
                   const int* __restrict__ hi, int* __restrict__ out, long long n_data,
                   int n_query, int d, int n_qtiles) {
  __shared__ __align__(16) uint2 q_h[KW * TQ];
  __shared__ __align__(16) int2 q_i[KD * TQ];
  __shared__ __align__(16) int d_s[KD * LDD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (int)(blockIdx.x % n_qtiles) * TQ;
  const long long n0 = (long long)(blockIdx.x / n_qtiles) * TN;
  const int chunks = d > 0 ? (d + KD - 1) / KD : 1;    // d = 0 still writes zeros

  for (int c = 0; c < chunks; ++c) {
    const int s0 = c * KD, ks = min(KD, d - s0);
    Words dw;
    QueryWords qw;
    const bool in = dw.load(data, n0, n_data, d, s0, ks);
    qw.load(lo, hi, q0, n_query, d, s0, ks);
    // also the barrier after the previous chunk's reads of the tiles
    const bool lanes = __syncthreads_and(in);
    qw.store(q_h, q_i);
    dw.store(d_s, lanes);
    __syncthreads();

    unsigned acc[RQ][RN];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0u;
    if (lanes) {
      for (int w = 0; w < (ks + 1) / 2; ++w) lanes_step(acc, d_s, q_h, warp, lane, w);
    } else {
      for (int a = 0; a < ks; ++a) ints_step(acc, d_s, q_i, warp, lane, a);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q = q0 + RQ * warp + i;
      if (q >= n_query) break;
      int* row = out + (long long)q * n_data;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const long long n = n0 + lane + 32 * j;
        if (n < n_data) row[n] = (c > 0 ? row[n] : 0) + lane_sum(acc[i][j]);
      }
    }
  }
}

}  // namespace

// data int32 [n_data, d], lo and hi int32 [n_query, d], out int32 [n_query,
// n_data], all contiguous device pointers (d >= 0).  Launches on `stream`, does
// not synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue on an empty or negative shape or a tile grid that does
// not fit one grid dimension.
extern "C" int repro_range_count(const void* data, const void* lo, const void* hi, void* out,
                                 long long n_data, int n_query, int d, void* stream) {
  if (n_data <= 0 || n_query <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + TQ - 1) / TQ;
  const long long blocks = n_qtiles * ((n_data + TN - 1) / TN);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  range_count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)data, (const int*)lo, (const int*)hi, (int*)out, n_data, n_query, d,
      (int)n_qtiles);
  return (int)cudaGetLastError();
}
