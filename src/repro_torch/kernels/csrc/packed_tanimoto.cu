// Packed TANIMOTO match-count for Hopper (sm_90a), two entry points over uint8
// minhash bucket ids (core/packing.py: ids in [0, 253]):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])   uint8 -> int32 [Q, N]
//
// Lanes past m never collide: the data side stages them as 255 and the query
// side as 254 (the TPU wrapper's pad sentinels, here only in shared memory;
// nothing is padded on the host).  The signature axis is staged as 32-bit
// words of four byte lanes (lane b of word w = column 4w + b), read from rows
// of m bytes by funnel shifts of aligned words (load_word), since a row is
// 4-byte aligned only when m is a multiple of 4.  A word pair's equal lanes
// are the zero bytes of q ^ d, found exactly by the carry-free test
// ~(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080 and counted by __popc
// (eq_lanes): five integer instructions and a popc per four columns.
//
// 1. `repro_packed_tanimoto_count` replaces `_count_kernel` /
//    `packed_tanimoto_count_pallas` (src/repro/kernels/packed_tanimoto.py),
//    which streams [128, 512] / [256, 512] byte slabs through VMEM along a
//    third grid axis and folds them eight columns at a time.  What bounds it
//    on an H100: instruction issue.  At Q = 1024, N = 281,250, m = 238 it
//    compares 6.85e10 (query, data, column) pairs against 1.15 GB of count
//    write.  eq_lanes on its own is integer-bound, ~57 pairs per SM-clock (five
//    instructions of the 64-lane integer pipe per four pairs); the float16
//    test of the equality tile (eq_tile.cuh: an HSET2, two issue slots of the
//    float16 pipe, and one add per two pairs) allows ~86.  So the bytes are
//    counted on the float16 pipe; measured on an H100 80GB HBM3 at 700 W, 4.46
//    ms at that shape, 69 % of the 3.07 ms that pipe allows (PERF.md):
//
//    - every byte is an id in [0, 253] or a pad, so it widens to a 16-bit lane
//      that is a distinct finite float16 (the pattern b; 0 is the only zero),
//      and no chunk needs the equality tile's int32 path; the widening (PRMT)
//      happens once per staged word, not once per pair;
//    - a chunk is 32 columns of a row, 8 staged byte words widened into 16
//      words of two float16 lanes, counted as the equality tile counts them:
//      an HSET2, then an HFMA2 that adds its 1.0 times 2^-24 into the
//      accumulator, whose lane holds a count k <= 2047 as the float16 k *
//      2^-24, i.e. with the bit pattern k (the subnormals and the first
//      binade of float16 are 2^-24 apart); the count is the sum of the lanes'
//      bits, an and and a shift, added into the int32 output every 127 chunks
//      and at the end;
//    - 512 threads, an 8 x 4 micro-tile, a [128, 128] output tile a block,
//      two blocks an SM; the chunks are double-buffered in shared memory, so
//      one barrier a chunk, and the last chunk of a row counts only the
//      groups of four columns that hold columns below m.
//
//    Counting a share of the words at the same time with eq_lanes on the
//    integer and popc pipes (into the same lanes' bits) makes the SASS allow
//    more pairs per SM-clock, but ran slower at every share measured
//    (PERF.md), so the kernel counts on the float16 pipe alone.
//
// 2. `repro_packed_tanimoto_topk` replaces `_topk_kernel` + `local_topk_tile`:
//    match -> count -> per-tile top-kc in one kernel, so the [Q, N] count
//    matrix is never written.  It is the fused kernel of fused_topk.cuh
//    (shared with packed_cosine_topk; its header says how an item is counted
//    and selected) with the byte-lane policy `ByteLanes4` below: words of four
//    lanes staged four at a time from five aligned 32-bit loads joined by
//    __funnelshift_r (load_words4), since a row of m bytes is 4-byte aligned
//    only when m is a multiple of 4; the pair count is eq_lanes.  Counts lie
//    in [0, m], m + 1 bins a row: one byte a count while m <= 254 (255 marks
//    a data row past the corpus) with 64 query rows an item, two bytes above
//    with 32, so no count collapses; the rows' bins live in shared memory up
//    to m = 503 and in device scratch for m > 503.  m is at most 65534.
//    What bounds it on an H100: the same word-pair work as the count kernel,
//    1.7e10 __popc per SIFT segment (Q=1024, N=281250, m=238) at 16 a clock
//    per SM, about 4.6 ms, against only the candidate buffers' bytes.  What
//    the design does about the rest: a data tile is staged once per 64 query
//    rows (16 times per 1024 queries), with one barrier pair per 16 words of
//    a 256-row sub-tile, and the selection's histogram rides on the count
//    write-back, so what stays serial per warp is passes 2 to 4.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_topk.cuh"

namespace {

constexpr uint8_t PAD_DATA = 255;     // staged past m on the data side
constexpr uint8_t PAD_QUERY = 254;    // ... and on the query side: never equal

// Equal byte lanes of two words: the zero bytes of a ^ b.  Per byte, (x & 0x7F)
// + 0x7F has bit 7 set iff the low seven bits are not all zero and never
// carries into the next byte; or-ing x adds bit 7 itself.
__device__ __forceinline__ int eq_lanes(unsigned a, unsigned b) {
  const unsigned x = a ^ b;
  const unsigned y = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
  return __popc(~(y | x) & 0x80808080u);
}

// Bytes [c, c + 4) of a row of m bytes as one word (lane b = byte c + b),
// lanes past m set to the pad: assembled by a funnel shift from the aligned
// words that hold them (a row is 4-byte aligned only when m is a multiple of
// 4), never reading past the aligned word that holds the row's last byte.
__device__ __forceinline__ unsigned load_word(const uint8_t* __restrict__ row, int m,
                                              int c, unsigned pad4) {
  const uintptr_t a = (uintptr_t)(row + c);
  const unsigned* __restrict__ p = (const unsigned*)(a & ~(uintptr_t)3);
  const unsigned sh = 8u * (unsigned)(a & 3);
  const int valid = m - c;
  const unsigned lo = p[0];
  if (valid >= 4) return __funnelshift_r(lo, sh ? p[1] : lo, sh);
  const unsigned* last = (const unsigned*)((a + valid - 1) & ~(uintptr_t)3);
  const unsigned word = __funnelshift_r(lo, p < last ? p[1] : lo, sh);
  const unsigned keep = (1u << (8 * valid)) - 1u;
  return (word & keep) | (pad4 & ~keep);
}

// Bytes [c, c + 16) of the row as four words: five aligned loads where the
// row holds all 16 bytes, else word by word.
__device__ __forceinline__ void load_words4(const uint8_t* __restrict__ row, int m, int c,
                                            unsigned pad4, unsigned (&x)[4]) {
  if (m - c >= 16) {
    const uintptr_t a = (uintptr_t)(row + c);
    const unsigned* __restrict__ p = (const unsigned*)(a & ~(uintptr_t)3);
    const unsigned sh = 8u * (unsigned)(a & 3);
    const unsigned v0 = p[0], v1 = p[1], v2 = p[2], v3 = p[3];
    const unsigned v4 = sh ? p[4] : v3;
    x[0] = __funnelshift_r(v0, v1, sh);
    x[1] = __funnelshift_r(v1, v2, sh);
    x[2] = __funnelshift_r(v2, v3, sh);
    x[3] = __funnelshift_r(v3, v4, sh);
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) x[b] = c + 4 * b < m ? load_word(row, m, c + 4 * b, pad4) : pad4;
  }
}

// ---- count ---------------------------------------------------------------
namespace count {

constexpr int TX = 32;                       // threads along N
constexpr int TY = 16;                       // threads along Q
constexpr int RQ = 8;                        // query rows per thread
constexpr int RN = 4;                        // data rows per thread
constexpr int TQ = TY * RQ;                  // 128 query rows per block
constexpr int TN = TX * RN;                  // 128 data rows per block
constexpr int THREADS = TX * TY;
constexpr int KH = 16;                       // float16 words a row per chunk
constexpr int KB = KH / 2;                   // byte words a row per chunk
constexpr int KS = 4 * KB;                   // columns per chunk
constexpr int LD = KH + 2;                   // 2 mod 4: conflict-free LDS.64
constexpr int FLUSH_CHUNKS = 2047 / KH;      // a lane gains at most KH a chunk
constexpr unsigned EPS2 = 0x00010001u;       // 2^-24 in both lanes

// two float16 lanes: 1.0 where they compare equal, else 0.0 (HSET2.BF.EQ)
__device__ __forceinline__ unsigned heq2(unsigned a, unsigned b) {
  unsigned r;
  asm("set.eq.f16x2.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// acc + e * 2^-24 in each lane: one more in the bits of a lane where e = 1.0
__device__ __forceinline__ unsigned add_bits(unsigned acc, unsigned e) {
  unsigned r;
  asm("fma.rn.f16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(e), "r"(EPS2), "r"(acc));
  return r;
}

// A thread's words of one chunk of rows [row0, row0 + ROWS): word e of the
// [ROWS, KB] chunk for e = threadIdx.x + THREADS * p.
template <int ROWS>
struct Words {
  static constexpr int STAGE = (ROWS * KB + THREADS - 1) / THREADS;
  unsigned w[STAGE];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ src, long long row0,
                                       long long n_rows, int m, int s0, unsigned pad4) {
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = threadIdx.x + THREADS * p;
      const long long row = row0 + e / KB;
      const int c = s0 + 4 * (e % KB);
      w[p] = pad4;
      if (e < ROWS * KB && row < n_rows && c < m) w[p] = load_word(src + row * m, m, c, pad4);
    }
  }

  // word k of a row widened into float16 words 2k, 2k + 1 (bytes 0, 1 and
  // 2, 3 as 16-bit lanes)
  __device__ __forceinline__ void store(unsigned* __restrict__ dst) const {
#pragma unroll
    for (int p = 0; p < STAGE; ++p) {
      const int e = threadIdx.x + THREADS * p;
      if (e >= ROWS * KB) continue;
      const int r = e / KB, k = e % KB;
      *reinterpret_cast<uint2*>(dst + r * LD + 2 * k) =
          make_uint2(__byte_perm(w[p], 0u, 0x4140), __byte_perm(w[p], 0u, 0x4342));
    }
  }
};

// float16 words 2g, 2g + 1 (four columns) of every row
__device__ __forceinline__ void lanes_step(unsigned (&acc)[RQ][RN], const unsigned* __restrict__ q_s,
                                           const unsigned* __restrict__ d_s, int tx, int ty, int g) {
  uint2 dv[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j)
    dv[j] = *reinterpret_cast<const uint2*>(d_s + (tx + TX * j) * LD + 2 * g);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const uint2 qv = *reinterpret_cast<const uint2*>(q_s + (ty + TY * i) * LD + 2 * g);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      acc[i][j] = add_bits(add_bits(acc[i][j], heq2(qv.x, dv[j].x)), heq2(qv.y, dv[j].y));
  }
}

// One chunk of `cols` columns: a whole chunk unrolled; the last chunk of a row
// only as far as it holds columns below m (the rest is padding, which counts
// nothing).
__device__ __forceinline__ void count_chunk(unsigned (&acc)[RQ][RN], const unsigned* __restrict__ q_s,
                                            const unsigned* __restrict__ d_s, int tx, int ty,
                                            int cols) {
  if (cols >= KS) {
#pragma unroll
    for (int g = 0; g < KH / 2; ++g) lanes_step(acc, q_s, d_s, tx, ty, g);
    return;
  }
  for (int g = 0; g < (cols + 3) / 4; ++g) lanes_step(acc, q_s, d_s, tx, ty, g);
}

// Add the lanes into the thread's output elements (written on the first
// flush of a tile, added to after) and clear them.
__device__ __forceinline__ void flush(unsigned (&acc)[RQ][RN], int* __restrict__ out,
                                      long long n_data, int n_query, int q0, long long n0,
                                      int tx, int ty, bool add) {
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int q = q0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const long long n = n0 + tx + TX * j;
      if (q < n_query && n < n_data) {
        int* o = out + (long long)q * n_data + n;
        *o = (add ? *o : 0) + (int)((acc[i][j] & 0xFFFFu) + (acc[i][j] >> 16));
      }
      acc[i][j] = 0u;
    }
  }
}

// two blocks per SM (at most 64 registers a thread); one block per (query
// tile, data tile), query tiles fastest
__global__ void __launch_bounds__(THREADS, 2)
packed_tanimoto_count_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ query,
                             int* __restrict__ out, long long n_data, int n_query, int m,
                             int n_qtiles) {
  __shared__ __align__(16) unsigned q_s[2][TQ * LD];
  __shared__ __align__(16) unsigned d_s[2][TN * LD];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int q0 = (int)(blockIdx.x % n_qtiles) * TQ;
  const long long n0 = (long long)(blockIdx.x / n_qtiles) * TN;
  const unsigned pad_q = PAD_QUERY * 0x01010101u, pad_d = PAD_DATA * 0x01010101u;

  unsigned acc[RQ][RN];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0u;

  Words<TQ> qw;
  Words<TN> dw;
  qw.load(query, q0, n_query, m, 0, pad_q);
  dw.load(data, n0, n_data, m, 0, pad_d);
  qw.store(q_s[0]);
  dw.store(d_s[0]);
  __syncthreads();
  const int chunks = (m + KS - 1) / KS;
  bool flushed = false;
  int since = 0;
  for (int c = 0; c < chunks; ++c) {
    const bool next = c + 1 < chunks;
    count_chunk(acc, q_s[c & 1], d_s[c & 1], tx, ty, m - c * KS);
    if (++since == FLUSH_CHUNKS && next) {
      flush(acc, out, n_data, n_query, q0, n0, tx, ty, flushed);
      flushed = true;
      since = 0;
    }
    if (next) {                             // into the buffer last read a barrier ago
      qw.load(query, q0, n_query, m, (c + 1) * KS, pad_q);
      dw.load(data, n0, n_data, m, (c + 1) * KS, pad_d);
      qw.store(q_s[(c + 1) & 1]);
      dw.store(d_s[(c + 1) & 1]);
    }
    __syncthreads();
  }
  flush(acc, out, n_data, n_query, q0, n0, tx, ty, flushed);
}

}  // namespace count

// ---- fused count -> per-tile top-k ---------------------------------------
using repro::fused_topk::Fused;
using repro::fused_topk::K_THREADS;
using repro::fused_topk::K_TN_NARROW;

// The byte-lane match of the fused kernel: rows of m bytes, four lanes a
// staged word, lanes past m and rows past the end staged as the pads.
struct ByteLanes4 {
  using Elem = uint8_t;
  static constexpr bool kCollapses = false;  // every count fits its tile
  int m;                                     // bytes per row

  __device__ int words() const { return (m + 3) / 4; }
  __device__ int row_elems() const { return m; }
  __device__ int nbins() const { return m + 1; }
  __device__ static int pair(unsigned a, unsigned b) { return eq_lanes(a, b); }
  __device__ static int count(int equal) { return equal; }

  // words [w, w + 4) of `row`, i.e. bytes [4w, 4w + 16)
  __device__ __forceinline__ void load4(const uint8_t* __restrict__ src, long long row,
                                        bool valid, int w, bool query, unsigned (&x)[4]) const {
    const unsigned pad4 = (query ? PAD_QUERY : PAD_DATA) * 0x01010101u;
    x[0] = x[1] = x[2] = x[3] = pad4;
    if (valid) load_words4(src + row * m, m, 4 * w, pad4, x);
  }
};

using CountU8 = Fused<uint8_t, 64, 16>;       // m <= 254
using CountU16 = Fused<uint16_t, 32, 16>;     // 254 < m <= 65534
// the same two with tiles of 1024 data rows (tile_n = 1024)
using CountU8Narrow = Fused<uint8_t, 64, 16, K_TN_NARROW>;
using CountU16Narrow = Fused<uint16_t, 32, 16, K_TN_NARROW>;

// one block of 16 warps an SM: at most 128 registers a thread; SCRATCH: the
// histograms' bins live in device scratch
template <class F, bool SCRATCH>
__global__ void __launch_bounds__(K_THREADS, 1)
packed_tanimoto_topk_kernel(const uint8_t* __restrict__ data,
                            const uint8_t* __restrict__ query,
                            int* __restrict__ ids, int* __restrict__ cnts,
                            long long n_data, int n_query, int m, int kc,
                            int n_tiles, int n_qtiles, int n_items,
                            int* __restrict__ hist_scratch) {
  repro::fused_topk::run<ByteLanes4, F, SCRATCH>(ByteLanes4{m}, data, query, ids, cnts, n_data,
                                                 n_query, kc, n_tiles, n_qtiles, n_items,
                                                 hist_scratch);
}

// the kernel of shape F for rows of nbins bins
template <class F>
auto tanimoto_kernel(int nbins) {
  return F::bins_in_shared(nbins) ? packed_tanimoto_topk_kernel<F, false>
                                  : packed_tanimoto_topk_kernel<F, true>;
}

// The launch shape (fused_topk::plan) and the launch of the fused kernel in
// the tile of U8 / U16 (one-byte counts up to m = 254, two above)
template <class U8, class U16>
int tanimoto_plan(long long n_data, int n_query, int m, int* grid, long long* scratch_ints) {
  if (n_data <= 0 || n_query <= 0 || m <= 0 || m > U16::MAX_M) return (int)cudaErrorInvalidValue;
  return m <= U8::MAX_M
      ? repro::fused_topk::plan<U8>(tanimoto_kernel<U8>(m + 1), n_data, n_query, m + 1, grid,
                                    scratch_ints)
      : repro::fused_topk::plan<U16>(tanimoto_kernel<U16>(m + 1), n_data, n_query, m + 1,
                                     grid, scratch_ints);
}

template <class U8, class U16>
int tanimoto_topk(const void* data, const void* query, void* ids, void* counts,
                  long long n_data, int n_query, int m, int kc, int grid, void* scratch,
                  void* stream) {
  if (n_data <= 0 || n_query <= 0 || m <= 0 || m > U16::MAX_M || kc < 1 || kc > U8::kTN ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const uint8_t* d = (const uint8_t*)data;
  const uint8_t* q = (const uint8_t*)query;
  return m <= U8::MAX_M
      ? repro::fused_topk::launch<U8>(tanimoto_kernel<U8>(m + 1), d, q, ids, counts, n_data,
                                      n_query, m, m + 1, kc, grid, scratch, stream)
      : repro::fused_topk::launch<U16>(tanimoto_kernel<U16>(m + 1), d, q, ids, counts, n_data,
                                       n_query, m, m + 1, kc, grid, scratch, stream);
}

}  // namespace

// data uint8 [n_data, m], query uint8 [n_query, m], out int32
// [n_query, n_data], contiguous device pointers.  Launches on `stream`, does
// not synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
extern "C" int repro_packed_tanimoto_count(const void* data, const void* query,
                                           void* out, long long n_data,
                                           int n_query, int m, void* stream) {
  if (n_data <= 0 || n_query <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + count::TQ - 1) / count::TQ;
  const long long blocks = n_qtiles * ((n_data + count::TN - 1) / count::TN);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  count::packed_tanimoto_count_kernel<<<(unsigned)blocks, count::THREADS, 0,
                                        (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint8_t*)query, (int*)out, n_data, n_query, m,
      (int)n_qtiles);
  return (int)cudaGetLastError();
}

// Launch shape of the fused kernel on the current device for rows of m bytes
// (1 <= m <= 65534): the number of persistent blocks, and the ints of device
// scratch the histograms need -- 0 when they live in shared memory, which
// they do for m <= 503 (one byte a count and 64 query rows an item up to m =
// 254, two bytes and 32 rows above); above m = 503, grid * 32 rows * (m + 1)
// ints.  Returns a CUDA error code, 0 on success.
extern "C" int repro_packed_tanimoto_topk_plan(long long n_data, int n_query,
                                               int m, int* grid,
                                               long long* scratch_ints) {
  return tanimoto_plan<CountU8, CountU16>(n_data, n_query, m, grid, scratch_ints);
}

// The same for tiles of 1024 data rows (tile_n = 1024).
extern "C" int repro_packed_tanimoto_topk_n1024_plan(long long n_data, int n_query,
                                                     int m, int* grid,
                                                     long long* scratch_ints) {
  return tanimoto_plan<CountU8Narrow, CountU16Narrow>(n_data, n_query, m, grid, scratch_ints);
}

// data uint8 [n_data, m], query uint8 [n_query, m] (1 <= m <= 65534); ids and
// counts int32 [n_query, ceil(n_data / tile_n) * kc] with 1 <= kc <= tile_n;
// `grid` and `scratch` (null, or the ints asked for) from
// repro_packed_tanimoto_topk_plan.  Every slot is written.  Launches on
// `stream`, does not synchronise.  Returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue on a shape or scratch the kernel does not take.
extern "C" int repro_packed_tanimoto_topk(const void* data, const void* query,
                                          void* ids, void* counts,
                                          long long n_data, int n_query, int m,
                                          int kc, int grid, void* scratch,
                                          void* stream) {
  return tanimoto_topk<CountU8, CountU16>(data, query, ids, counts, n_data, n_query, m, kc,
                                          grid, scratch, stream);
}

// The same for tiles of 1024 data rows: tile_n = 1024, 1 <= kc <= 1024; `grid`
// and `scratch` from repro_packed_tanimoto_topk_n1024_plan.
extern "C" int repro_packed_tanimoto_topk_n1024(const void* data, const void* query,
                                                void* ids, void* counts,
                                                long long n_data, int n_query, int m,
                                                int kc, int grid, void* scratch,
                                                void* stream) {
  return tanimoto_topk<CountU8Narrow, CountU16Narrow>(data, query, ids, counts, n_data,
                                                      n_query, m, kc, grid, scratch, stream);
}
