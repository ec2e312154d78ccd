// Packed TANIMOTO match-count for Hopper (sm_90a), two entry points over uint8
// minhash bucket ids (core/packing.py: ids in [0, 253]):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])   uint8 -> int32 [Q, N]
//
// Equality is counted four byte lanes at a time: the signature axis is staged
// into shared memory as 32-bit words (lane b of word w = column 4w + b), and a
// word pair gives its number of equal lanes as the zero bytes of q ^ d, found
// exactly by the carry-free test ~(((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) &
// 0x80808080 and counted by __popc: an xor, an and, an add, an or-not, a popc
// and the accumulating add per four columns.  Lanes past m never collide: the
// data side stages them as 255 and the query side as 254 (the TPU wrapper's pad
// sentinels, here only in shared memory; nothing is padded on the host).
//
// 1. `repro_packed_tanimoto_count` replaces `_count_kernel` /
//    `packed_tanimoto_count_pallas` (src/repro/kernels/packed_tanimoto.py),
//    which streams [128, 512] / [256, 512] byte slabs through VMEM along a
//    third grid axis and folds them eight columns at a time.  Here it is the
//    EQ kernel's tile (eq_tile.cuh) with a word of four lanes per slot
//    (ByteLanes): a block owns a [128, 128] output tile, stages 16 words (64
//    columns) of both sides per step (stage_words, below), and every thread
//    keeps an 8 x 8 register micro-tile, so one staged word feeds 8 lane
//    counts.  Ragged edges are masked in the kernel.  Of the
//    two ways to count lanes, __vseteq4 summed by __dp4a and the zero-byte
//    test with __popc, ptxas emits as many instructions per word pair for one
//    as for the other (PERF.md); this kernel takes the second.
//    What bounds it on an H100: integer issue.  At Q=1024, N=281250, m=238
//    (60 words) the Q*N*60 = 1.7e10 word pairs cost about six integer
//    instructions each, against a Q*N*4-byte count write of 1.15 GB.
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

#include "eq_tile.cuh"
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

// Stage words [w0, w0 + kw) of rows [row0, row0 + rows) of a row-major uint8
// [n_rows, m] matrix: row r's word w0 + w at dst[r * ld + w], four words a
// thread; the words of a group past kw are staged but never counted.  Rows
// past n_rows are staged as `pad`.  A block of NT threads.
template <int KW, int NT>
__device__ __forceinline__ void stage_words(unsigned* __restrict__ dst, int ld,
                                            const uint8_t* __restrict__ src,
                                            long long row0, long long n_rows, int m,
                                            int w0, int kw, int rows, uint8_t pad) {
  constexpr int G = KW / 4;
  const unsigned pad4 = pad * 0x01010101u;
  for (int e = threadIdx.x; e < rows * G; e += NT) {
    const int r = e / G;
    const int w = 4 * (e % G);
    if (w >= kw) continue;
    const long long row = row0 + r;
    unsigned x[4] = {pad4, pad4, pad4, pad4};
    if (row < n_rows) load_words4(src + row * m, m, 4 * (w0 + w), pad4, x);
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[r * ld + w + b] = x[b];
  }
}

// ---- count -------------------------------------------------------------
// The tile of eq_tile.cuh with four byte lanes per staged slot.
struct ByteLanes {
  using Elem = uint8_t;
  using QSlot = unsigned;
  using DSlot = unsigned;
  static constexpr int KS = 16;   // words (64 columns) staged per step

  __device__ static int slots(int m) { return (m + 3) / 4; }

  __device__ __forceinline__ static void stage(unsigned* __restrict__ dst, int ld,
                                               const uint8_t* __restrict__ src,
                                               long long row0, long long n_rows,
                                               int m, int s0, int rows, bool query) {
    stage_words<KS, repro::eq_tile::THREADS>(dst, ld, src, row0, n_rows, m, s0,
                                             min(KS, slots(m) - s0), rows,
                                             query ? PAD_QUERY : PAD_DATA);
  }

  __device__ __forceinline__ static int count(unsigned a, unsigned b) {
    return eq_lanes(a, b);
  }
};

// two blocks per SM: left to itself ptxas gives the unrolled step 250
// registers and one block per SM, which ran slower on an H100 (PERF.md)
__global__ void __launch_bounds__(repro::eq_tile::THREADS, 2)
packed_tanimoto_count_kernel(const uint8_t* __restrict__ data,
                             const uint8_t* __restrict__ query,
                             int* __restrict__ out, long long n_data,
                             int n_query, int m, int n_qtiles) {
  repro::eq_tile::count_tile<ByteLanes>(data, query, out, n_data, n_query, m,
                                        n_qtiles);
}

// ---- fused count -> per-tile top-k ---------------------------------------
using repro::fused_topk::Fused;
using repro::fused_topk::K_THREADS;

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

}  // namespace

// data uint8 [n_data, m], query uint8 [n_query, m], out int32
// [n_query, n_data], contiguous device pointers.  Launches on `stream`, does
// not synchronise.  Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when the tile grid does not fit one grid dimension.
extern "C" int repro_packed_tanimoto_count(const void* data, const void* query,
                                           void* out, long long n_data,
                                           int n_query, int m, void* stream) {
  return repro::eq_tile::launch<ByteLanes>(packed_tanimoto_count_kernel, data,
                                           query, out, n_data, n_query, m,
                                           stream);
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
  if (n_data <= 0 || n_query <= 0 || m <= 0 || m > CountU16::MAX_M)
    return (int)cudaErrorInvalidValue;
  return m <= CountU8::MAX_M
      ? repro::fused_topk::plan<CountU8>(tanimoto_kernel<CountU8>(m + 1), n_data, n_query,
                                         m + 1, grid, scratch_ints)
      : repro::fused_topk::plan<CountU16>(tanimoto_kernel<CountU16>(m + 1), n_data, n_query,
                                          m + 1, grid, scratch_ints);
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
  if (n_data <= 0 || n_query <= 0 || m <= 0 || m > CountU16::MAX_M || kc < 1 ||
      kc > repro::fused_topk::K_TN || grid < 1)
    return (int)cudaErrorInvalidValue;
  const uint8_t* d = (const uint8_t*)data;
  const uint8_t* q = (const uint8_t*)query;
  return m <= CountU8::MAX_M
      ? repro::fused_topk::launch<CountU8>(tanimoto_kernel<CountU8>(m + 1), d, q, ids, counts,
                                           n_data, n_query, m, m + 1, kc, grid, scratch, stream)
      : repro::fused_topk::launch<CountU16>(tanimoto_kernel<CountU16>(m + 1), d, q, ids,
                                            counts, n_data, n_query, m, m + 1, kc, grid,
                                            scratch, stream);
}
