// The fused match -> count -> per-tile top-k kernel for Hopper (sm_90a), one
// template for the two packed layouts: packed_cosine.cu instantiates it with
// sign words (`SignWords`: xor and popcount), packed_tanimoto.cu with byte
// lanes of minhash ids (`ByteLanes4`: four equal-lane tests a word).
//
// Replaces `_topk_kernel` + `local_topk_tile` (src/repro/kernels/
// packed_cosine.py, packed_tanimoto.py): match -> count -> the top kc of
// every tile of TN data rows, so the [Q, N] count matrix is never written.
// TN is a template parameter of the shape (Fused), one of two the wrappers'
// tile_n picks: K_TN = 2048, the default, and K_TN_NARROW = 1024 (the TPU's
// tile is 256).  Only the result after topk_from_candidates has to equal the
// reference; the tile sets the kernel's parallelism (items of TQ rows x TN
// rows) against the candidates topk_from_candidates sorts: the buffers ids /
// counts int32 [Q, ceil(N / TN) * kc] shrink as TN grows.
//
// An item is TQ query rows against one tile.  Its [TQ, TN] counts live in
// shared memory, 128 KB at TN = 2048 (64 KB at 1024): one byte a count with
// TQ = 64, two bytes with TQ = 32.  A tile of 4096 rows is not offered: at
// 64 rows of one-byte counts it is 256 KB, above the 227 KB a block may have,
// and pass 4 below holds a lane's share of a row (TN / 32 entries) as bits of
// one 64-bit word.  The tile is counted in sub-tiles of SN data rows: the words stream KW
// a step, the 512 threads stage the step's words of the sub-tile (and of the
// TQ query rows, once per item where one step holds the whole width), and
// each thread counts an 8 x 4 register micro-tile (8 query rows x 4 data
// rows: a staged data word feeds 8 pair counts, a query word 4) with its
// accumulators kept across the steps.  When a sub-tile is counted, each
// thread turns its 32 accumulators into exact counts, stores them into the
// tile and adds them to their query rows' histograms (shared-memory atomics,
// nbins a row), so the selection starts from a finished histogram: each of
// the 16 warps then selects TQ / 16 rows by counting (passes 2 to 4 below).
// Blocks are persistent (one an SM) and walk the (query tile, data tile)
// items with query tiles fastest, so the blocks in flight share a data tile
// in L2.  The rows' bins live in shared memory beside the tile, or, where
// they do not fit, in a device scratch buffer the wrapper allocates.
//
// The count tile's low end.  A stored count is s = max(c - L, 0) with L =
// max(0, nbins - 1 - (PAST - 1)), PAST (the type's largest value) marking a
// data row past the corpus: every count above L is stored exactly, every
// count at or below L as 0.  L is 0 -- nothing collapses -- unless the
// counts outgrow the type (packed COSINE with one-byte counts and W >= 8:
// counts in [0, 32W], L = 32W - 254).  The histograms are built from the
// registers, so they and the threshold t are exact; an entry stored as 0
// (count <= L) can only be selected when t <= L, and then pass 4 recounts it
// from device memory.  So the result is exact for every width.
//
// The selection, per row, replaces the reference's kc rounds of "max, then
// the smallest id at the max, then knock it out" (kc * TN compares):
//
//   (1. the histogram: built by the count write-back, above;)
//   2. the threshold t, the largest count with #{count >= t} >= kc (0 when
//      the row holds fewer than kc valid entries), by a warp scan of the bins
//      from the top;
//   3. in the same scan, for every count c >= t its first output slot,
//      #{count > c}, written over the histogram;
//   4. the entries taken: those above t (fewer than kc) all fit, each at
//      slot #{count > c} + its rank among the equal counts in id order, and
//      those at t fill the remaining slots in id order.  Each lane reads 64
//      consecutive entries into registers and counts the ones above and at
//      t; prefix sums over the lanes give every entry at t its slot, and list
//      the entries above t in id order in the warp's part of the (idle)
//      staging area, from where they take their slots 32 at a time (ranks
//      among equal counts from __match_any_sync).  A row with more entries
//      above t than that part holds (168 with 64 query rows an item, 288 with
//      32) goes step by step instead, 32 entries at a time in id order.
//
// So a row's kc slots hold its best entries by (count desc, id asc), exactly
// as the reference's extraction orders them, and slots past the row's valid
// entries are -1 / -1.  The result is exact and the same on every run: the
// histogram is a sum, and nothing else depends on the order in which lanes or
// warps run.
//
// What bounds it on an H100: the pair work of the match (xor + popcount +
// add per word pair for COSINE; six integer instructions per four byte lanes
// for TANIMOTO), about 16 popcounts per SM-clock, against only the candidate
// buffers' bytes.  The selection runs while no warp of the block counts (one
// block an SM), so it is kept to few instructions an entry: a warp-wide
// step per 32 entries, with its ballots and shuffles, cost more than the
// count at W = 8 (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace fused_topk {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int K_TN = 2048;                    // data rows per tile: the default shape
constexpr int K_TN_NARROW = 1024;             // data rows per tile: the narrow shape
constexpr int K_THREADS = 512;
constexpr int K_WARPS = K_THREADS / 32;
constexpr int K_RQ = 8;                       // query rows per thread
constexpr int K_RN = 4;                       // data rows per thread and sub-tile
constexpr int MAX_SMEM = 232448;              // 227 KB: the most a block may ask

// One shape of the fused kernel: the count type of its [TQ, TN] tile, TQ
// query rows per item, KW words staged per step, TN data rows per tile.
// Shared memory: the count tile, then the TQ rows' histograms (where they
// fit), then the staged data and query words.
template <typename CountT, int TQ, int KW, int TN = K_TN>
struct Fused {
  using Count = CountT;
  static constexpr int kTQ = TQ;
  static constexpr int kKW = KW;
  static constexpr int kTN = TN;
  static constexpr int TYQ = TQ / K_RQ;                 // threads along the queries
  static constexpr int TXN = K_THREADS / TYQ;           // threads along the data rows
  static constexpr int SN = TXN * K_RN;                 // data rows per sub-tile
  static constexpr int LDD = KW + 1;                    // odd stride: conflict-free rows
  static constexpr int CNT_BYTES = TQ * TN * (int)sizeof(CountT);
  static constexpr int STAGE_BYTES = (SN * LDD + TQ * KW) * 4;
  static constexpr int PAST = (int)(CountT)~0u;         // marks a row past the corpus
  static constexpr int MAX_M = PAST - 1;                // the largest count stored as itself
  static constexpr int LIST_CAP = STAGE_BYTES / 8 / K_WARPS;   // pass 4's list, a warp
  static_assert(TN % SN == 0 && TXN % 32 == 0 && KW % 4 == 0,
                "sub-tiles cover the tile; a warp shares its query rows; 4-word loads");
  static_assert(TN % 32 == 0 && TN / 32 <= 64 && TN / 32 * (int)sizeof(CountT) % 16 == 0,
                "pass 4: a lane's share of a row is at most 64 entries, 16-byte loads");

  // L: counts at or below it are stored as 0 (none while nbins <= PAST)
  __host__ __device__ static int low(int nbins) { return nbins - 1 > MAX_M ? nbins - 1 - MAX_M : 0; }
  __host__ static bool bins_in_shared(int nbins) {
    return CNT_BYTES + STAGE_BYTES + (long long)TQ * nbins * 4 <= MAX_SMEM;
  }
  __host__ static int smem(int nbins) {
    return CNT_BYTES + STAGE_BYTES + (bins_in_shared(nbins) ? TQ * nbins * 4 : 0);
  }
};

// Inclusive scan over the 32 lanes (lane 0 first).
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Pass 4 step by step, for a row whose entries above t outnumber what its
// bytes can list, or whose collapsed counts may be taken (t <= L): 32
// entries a step in id order, an entry with count c >= t takes slot hist[c]
// + its rank among the equal counts of lower lanes (a ballot per distinct
// count taken), written while below kc.
template <int TN, typename T, typename Decode>
__device__ inline void ordered_steps(const T* __restrict__ row, long long gid0, int* hist,
                                     int t, int kc, int* __restrict__ out_ids,
                                     int* __restrict__ out_cnt, const Decode& decode) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < TN; base += 32) {
    const int i = base + lane;
    const int c = decode((int)row[i], i, t);
    const bool take = c >= t;
    for (unsigned todo = __ballot_sync(kFullMask, take); todo;) {
      const int leader = __ffs(todo) - 1;
      const int cl = __shfl_sync(kFullMask, c, leader);
      const bool peer = take && c == cl;
      const unsigned peers = __ballot_sync(kFullMask, peer);
      if (peer) {
        const int slot = hist[cl] + __popc(peers & lower);
        if (slot < kc) {
          out_ids[slot] = (int)(gid0 + i);
          out_cnt[slot] = c;
        }
      }
      __syncwarp();
      // the count's next slot moves past the group
      if (lane == leader) hist[cl] += __popc(peers);
      __syncwarp();
      todo &= ~peers;
    }
  }
}

// SWAR over the entries of a 32-bit word of the count tile (four one-byte
// or two two-byte lanes): each test sets the top bit of every lane that
// passes it.
template <typename T>
struct Lanes {
  static constexpr int BITS = 8 * (int)sizeof(T);
  static constexpr unsigned H = sizeof(T) == 1 ? 0x80808080u : 0x80008000u;
  static constexpr unsigned ONES = sizeof(T) == 1 ? 0x01010101u : 0x00010001u;
  __device__ static unsigned splat(unsigned x) { return x * ONES; }
  // x == y: a lane of z = x ^ y is zero iff adding 0x7F..F to its low bits
  // leaves its top bit clear and its own top bit is clear (no carry between
  // lanes)
  __device__ static unsigned eq(unsigned x, unsigned y) {
    const unsigned z = x ^ y;
    return ~(((z & ~H) + ~H) | z) & H;
  }
  // x >= y, unsigned: the low bits compare in the top bit of (x | H) - (y &
  // ~H) (each lane of it >= 1, so no borrow between lanes); the top bits
  // decide where they differ
  __device__ static unsigned ge(unsigned x, unsigned y) {
    const unsigned d = (x | H) - (y & ~H);
    return ((x & ~y) | (~(x ^ y) & d)) & H;
  }
  // lanes >= lo (lo splatted) that are not PAST (all ones)
  __device__ static unsigned live_ge(unsigned x, unsigned lo) { return ge(x, lo) & ~eq(x, ~0u); }
  // the flags of a word as PER consecutive bits (lane 0 lowest): one multiply
  // gathers the top bits, which land on distinct bits
  __device__ static unsigned compress(unsigned f) {
    return sizeof(T) == 1 ? (((f >> 7) * 0x00204081u) >> 21) & 0xFu
                          : (((f >> 15) * 0x00008001u) >> 15) & 0x3u;
  }
};

// Pass 4, the ties and the list: `at` / `above` hold a bit for each of the
// lane's SPAN entries [first, first + SPAN) at t and above t.  Every entry at
// t takes its slot directly (s: #{count > t} + the entries at t before the
// lane's), up to kc; each entry above t is listed in id order, (id in the
// tile, count) from list[a] on.
template <typename T>
__device__ __forceinline__ void list_and_ties(const T* __restrict__ row, unsigned long long at,
                                              unsigned long long above, int first, int t,
                                              int low, int a, int s, int kc, long long gid0,
                                              int2* list, int* __restrict__ out_ids,
                                              int* __restrict__ out_cnt) {
  for (; at && s < kc; at &= at - 1, ++s) {
    out_ids[s] = (int)(gid0 + first + __ffsll(at) - 1);
    out_cnt[s] = t;
  }
  for (; above; above &= above - 1) {
    const int i = first + __ffsll(above) - 1;
    list[a++] = make_int2(i, (int)row[i] + low);
  }
}

// Pass 4, the list: its n entries (id order) take their slots 32 at a time,
// the rank among equal counts from __match_any_sync, the count's next slot
// from hist (#{count > c} on entry).
__device__ __forceinline__ void place_list(const int2* list, int n, long long gid0, int* hist,
                                           int* __restrict__ out_ids,
                                           int* __restrict__ out_cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    const bool take = j < n;
    const int2 x = take ? list[j] : make_int2(0, -1);
    const unsigned peers = __match_any_sync(kFullMask, x.y);
    if (take) {
      const int slot = hist[x.y] + __popc(peers & lower);
      out_ids[slot] = (int)(gid0 + x.x);
      out_cnt[slot] = x.y;
    }
    __syncwarp();
    // the group's highest lane moves the count's next slot past the group
    if (take && lane == 31 - __clz(peers)) hist[x.y] += __popc(peers);
    __syncwarp();
  }
}

// Passes 2 to 4 -- whole warp, converged: `hist` (nbins ints) holds the
// histogram of the row's valid counts, and `list` (list_cap entries) is
// scratch; only this warp touches them.  The row's TN entries have ids gid0
// + i and are stored as max(c - low, 0), PAST (the type's largest value) for
// no entry; decode(stored, i, t) gives entry i's exact count (< nbins), or -1
// where it cannot reach t (PAST, a collapsed count while t > low).  Writes kc
// slots to out_ids / out_cnt and leaves `hist` zero.
template <int TN, typename T, typename Decode>
__device__ inline void warp_topk_from_histogram(const T* __restrict__ row, long long gid0,
                                                int* hist, int nbins, int kc, int low,
                                                int2* list, int list_cap,
                                                int* __restrict__ out_ids,
                                                int* __restrict__ out_cnt,
                                                const Decode& decode) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;

  // 2. and 3. bins are scanned from the top in chunks of 32 (lane 0 holds the
  // chunk's highest bin; `above` counts the entries above the chunk) down to
  // the chunk that holds t, each bin replaced by its count's first slot,
  // #{count > b}
  int t = 0;
  int n_at_least_t = 0;     // #{count >= t}
  bool found = false;
  int above = 0;
  for (int top = nbins - 1; top >= 0 && !found; top -= 32) {
    const int b = top - lane;
    const int h = b >= 0 ? hist[b] : 0;
    const int incl = warp_inclusive_scan(h);
    const int at_least = above + incl;                  // #{count >= b}
    if (b >= 0) hist[b] = at_least - h;
    const unsigned hit = __ballot_sync(kFullMask, b >= 0 && at_least >= kc);
    if (hit) {
      const int l = __ffs(hit) - 1;
      t = top - l;
      n_at_least_t = __shfl_sync(kFullMask, at_least, l);
      found = true;
    } else {
      above += __shfl_sync(kFullMask, incl, 31);
    }
  }
  if (!found) {             // fewer than kc valid entries: take them all
    t = 0;
    n_at_least_t = above;
  }
  __syncwarp();

  // 4. the entries taken: fewer than kc lie above t and all fit, the ones at
  // t fill the remaining slots in id order.  Where t > low, every count that
  // can reach t is stored exactly (c = s + low).  Each lane then reads its
  // SPAN entries [SPAN * lane, SPAN * lane + SPAN) and flags those above and
  // at t, a word at a time (Lanes); prefix sums over the lanes give every
  // entry at t its slot directly and list the entries above t in id order,
  // which then take their slots.
  constexpr int SPAN = TN / 32;
  constexpr int WORDS = SPAN * (int)sizeof(T) / 4;
  using L = Lanes<T>;
  unsigned v[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS / 4; ++j) {
    const uint4 x = reinterpret_cast<const uint4*>(row)[lane * (WORDS / 4) + j];
    v[4 * j] = x.x, v[4 * j + 1] = x.y, v[4 * j + 2] = x.z, v[4 * j + 3] = x.w;
  }
  const unsigned at_v = L::splat(t - low), above_v = L::splat(t - low + 1);
  constexpr int PER = 4 / (int)sizeof(T);
  unsigned long long at_bits = 0, above_bits = 0;     // a bit an entry
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    at_bits |= (unsigned long long)L::compress(L::eq(v[j], at_v)) << (PER * j);
    above_bits |= (unsigned long long)L::compress(L::live_ge(v[j], above_v)) << (PER * j);
  }
  const int n_at = __popcll(at_bits), n_above = __popcll(above_bits);
  const int incl_above = warp_inclusive_scan(n_above);
  const int incl_at = warp_inclusive_scan(n_at);
  const int total_above = __shfl_sync(kFullMask, incl_above, 31);   // #{count > t}
  if ((low > 0 && t <= low) || total_above > list_cap) {
    ordered_steps<TN>(row, gid0, hist, t, kc, out_ids, out_cnt, decode);
  } else {
    list_and_ties(row, at_bits, above_bits, lane * SPAN, t, low, incl_above - n_above,
                  total_above + incl_at - n_at, kc, gid0, list, out_ids, out_cnt);
    __syncwarp();
    place_list(list, total_above, gid0, hist, out_ids, out_cnt);
  }

  // exhausted slots, then leave the scratch zero for the next row
  for (int s = min(kc, n_at_least_t) + lane; s < kc; s += 32) {
    out_ids[s] = -1;
    out_cnt[s] = -1;
  }
  for (int b = lane; b < nbins; b += 32) hist[b] = 0;
  __syncwarp();
}

// The stored count of one tile entry back to its exact count (passes 4).
template <class M, class F>
struct Decoder {
  const M& match;
  int low;                                     // F::low(nbins)
  const typename M::Elem* __restrict__ query_row;
  const typename M::Elem* __restrict__ data;   // the tile's first row
  __device__ int operator()(int s, int i, int t) const {
    if (s == F::PAST) return -1;
    if constexpr (!M::kCollapses) {
      return s;
    } else {
      if (s > 0 || low == 0) return s + low;
      return t <= low ? match.recount(query_row, data, i) : -1;  // a count <= L
    }
  }
};

// Stage words [w0, w0 + kw) of rows [row0, row0 + rows) of the row-major
// matrix `src`: row r's word w0 + w at dst[r * ld + w], four words a thread
// (M::load4); rows past n_rows and words past the row's end staged as the
// policy's pad, words of a group past kw staged but never counted.
template <class M, int KW>
__device__ __forceinline__ void stage(const M& match, unsigned* __restrict__ dst, int ld,
                                      const typename M::Elem* __restrict__ src, long long row0,
                                      long long n_rows, int w0, int kw, int rows, bool query) {
  constexpr int G = KW / 4;
  for (int e = threadIdx.x; e < rows * G; e += K_THREADS) {
    const int r = e / G;
    const int w = 4 * (e % G);
    if (w >= kw) continue;
    const long long row = row0 + r;
    unsigned x[4];
    match.load4(src, row, row < n_rows, w0 + w, query, x);
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[r * ld + w + b] = x[b];
  }
}

// The kernel body: the match policy M gives the element type (Elem) and its
// count per row (row_elems()), the staged words per row (words()), the pads
// (load4), the count of a word pair (pair()), the exact count from the summed
// pair counts (count()), nbins(), and -- where its counts can outgrow the
// tile (kCollapses) -- recount() for a collapsed entry.
template <class M, class F, bool SCRATCH>
__device__ __forceinline__ void run(const M& match, const typename M::Elem* __restrict__ data,
                                    const typename M::Elem* __restrict__ query,
                                    int* __restrict__ ids, int* __restrict__ cnts,
                                    long long n_data, int n_query, int kc, int n_tiles,
                                    int n_qtiles, int n_items, int* __restrict__ hist_scratch) {
  using C = typename F::Count;
  constexpr int TQ = F::kTQ;
  constexpr int KW = F::kKW;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbins = match.nbins();
  const int low = M::kCollapses ? F::low(nbins) : 0;
  constexpr int TN = F::kTN;
  C* cnt_s = (C*)smem;                                  // [TQ][TN]
  // [TQ][nbins]: which memory is known when compiled, so that the bins in
  // shared memory take shared-memory instructions (LDS, ATOMS)
  int* hist = SCRATCH ? hist_scratch + (long long)blockIdx.x * TQ * nbins
                      : (int*)(smem + F::CNT_BYTES);
  unsigned* d_s = (unsigned*)(smem + F::CNT_BYTES) + (SCRATCH ? 0 : TQ * nbins);
  unsigned* q_s = d_s + F::SN * F::LDD;                 // [SN][LDD], [TQ][KW]
  // during the selection the staging area is free: a list of LIST_CAP
  // entries a warp
  int2* list = reinterpret_cast<int2*>(d_s) + (threadIdx.x >> 5) * F::LIST_CAP;
  const int warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % F::TXN;
  const int ty = threadIdx.x / F::TXN;
  // zero once: a selection leaves its row's bins zero, and only the rows of
  // real queries are filled
  for (int b = threadIdx.x; b < TQ * nbins; b += K_THREADS) hist[b] = 0;
  const int words = match.words();
  const int n_chunks = (words + KW - 1) / KW;
  const long long slots = (long long)n_tiles * kc;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = (item % n_qtiles) * TQ;
    const int tile = item / n_qtiles;
    const long long n0 = (long long)tile * TN;

    for (int s0 = 0; s0 < TN; s0 += F::SN) {
      int acc[K_RQ][K_RN];
#pragma unroll
      for (int i = 0; i < K_RQ; ++i)
#pragma unroll
        for (int j = 0; j < K_RN; ++j) acc[i][j] = 0;

      for (int c = 0; c < n_chunks; ++c) {
        const int w0 = c * KW;
        const int kw = min(KW, words - w0);
        // the staging area is free: the previous step, sub-tile or item's
        // selection is done with it
        __syncthreads();
        if (n_chunks > 1 || s0 == 0)    // whole width: the query rows stay for the item
          stage<M, KW>(match, q_s, KW, query, q0, n_query, w0, kw, TQ, true);
        stage<M, KW>(match, d_s, F::LDD, data, n0 + s0, n_data, w0, kw, F::SN, false);
        __syncthreads();
        // words past the width hold pads on both sides, which never count
#pragma unroll 2
        for (int kk = 0; kk < kw; ++kk) {
          unsigned qv[K_RQ], dv[K_RN];
#pragma unroll
          for (int i = 0; i < K_RQ; ++i) qv[i] = q_s[(ty + F::TYQ * i) * KW + kk];
#pragma unroll
          for (int j = 0; j < K_RN; ++j) dv[j] = d_s[(tx + F::TXN * j) * F::LDD + kk];
#pragma unroll
          for (int i = 0; i < K_RQ; ++i)
#pragma unroll
            for (int j = 0; j < K_RN; ++j) acc[i][j] += M::pair(qv[i], dv[j]);
        }
      }

      // this sub-tile's counts into the tile and into their query rows'
      // histograms; rows past the corpus never enter
#pragma unroll
      for (int i = 0; i < K_RQ; ++i) {
        const int qr = ty + F::TYQ * i;
        const bool live = q0 + qr < n_query;
#pragma unroll
        for (int j = 0; j < K_RN; ++j) {
          const int r = s0 + tx + F::TXN * j;
          const bool real = n0 + r < n_data;
          const int cnt = match.count(acc[i][j]);
          const int stored = M::kCollapses ? (cnt > low ? cnt - low : 0) : cnt;
          cnt_s[qr * TN + r] = (C)(real ? stored : F::PAST);
          if (real && live) atomicAdd(hist + qr * nbins + cnt, 1);
        }
      }
    }
    __syncthreads();                    // the tile and its histograms are complete

    for (int r = warp; r < TQ; r += K_WARPS) {
      const int q = q0 + r;
      if (q >= n_query) break;
      const long long at = (long long)q * slots + (long long)tile * kc;
      const Decoder<M, F> decode{match, low, query + (long long)q * match.row_elems(),
                                 data + n0 * match.row_elems()};
      warp_topk_from_histogram<TN>(cnt_s + r * TN, n0, hist + r * nbins, nbins, kc, low,
                                   list, F::LIST_CAP, ids + at, cnts + at, decode);
    }
  }
}

// Launch shape of a fused kernel of shape F (`kernel`: the instantiation
// for bins in shared memory or in scratch, as F::bins_in_shared(nbins) says):
// persistent blocks, as many as the occupancy calculator fits (one an SM),
// and the histograms' device scratch (0 ints when they live in shared
// memory).
template <class F, class Kernel>
int plan(Kernel kernel, long long n_data, int n_query, int nbins, int* grid,
         long long* scratch_ints) {
  const int smem = F::smem(nbins);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_qtiles = (n_query + F::kTQ - 1) / F::kTQ;
  const long long n_tiles = (n_data + F::kTN - 1) / F::kTN;
  const long long items = n_qtiles * n_tiles;
  if (items > 2147483647LL || per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long fit = (long long)sms * per_sm;
  *grid = (int)(items < fit ? items : fit);
  *scratch_ints = F::bins_in_shared(nbins) ? 0 : (long long)(*grid) * F::kTQ * nbins;
  return 0;
}

// Launch a fused kernel of shape F: kernel(data, query, ids, counts, n_data,
// n_query, width, kc, n_tiles, n_qtiles, n_items, hist_scratch).
template <class F, class Kernel, class Elem>
int launch(Kernel kernel, const Elem* data, const Elem* query, void* ids, void* counts,
           long long n_data, int n_query, int width, int nbins, int kc, int grid,
           void* scratch, void* stream) {
  if (!F::bins_in_shared(nbins) && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (n_query + F::kTQ - 1) / F::kTQ;
  const long long n_tiles = (n_data + F::kTN - 1) / F::kTN;
  if (n_qtiles * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int smem = F::smem(nbins);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, K_THREADS, smem, (cudaStream_t)stream>>>(
      data, query, (int*)ids, (int*)counts, n_data, n_query, width, kc, (int)n_tiles,
      (int)n_qtiles, (int)(n_qtiles * n_tiles),
      F::bins_in_shared(nbins) ? nullptr : (int*)scratch);
  return (int)cudaGetLastError();
}

}  // namespace fused_topk
}  // namespace repro
