// Per-tile local top-k by counting, for one row of a count tile held in shared
// memory: the selection step of the fused match -> count -> top-k kernels
// (packed_cosine.cu over an int32 tile, packed_tanimoto.cu over a uint8 or
// uint16 tile).
//
// Replaces `local_topk_tile` (src/repro/kernels/packed_cosine.py), which the
// TPU kernels run as kc rounds of "max, then the smallest id at the max, then
// knock it out" -- kc * TN compares per row and tile.  Match counts live in a
// small domain [0, nbins), so here one warp selects a row in four passes:
//
//   1. a histogram of the row's counts (equal counts in a warp are grouped by
//      __match_any_sync, one lane adds the group's size);
//   2. the threshold t, the largest count with #{count >= t} >= kc (0 when the
//      row holds fewer than kc valid entries), by a warp scan of the bins from
//      the top;
//   3. for every count c >= t its first output slot, #{count > c}, by the same
//      scan, written over the histogram;
//   4. one pass over the row in id order: an entry with count c >= t takes
//      slot base[c] + (its rank among the equal counts of lower lanes), and is
//      written while that slot is below kc.  Every entry above t fits, entries
//      at t fill the remaining slots in id order.
//
// So a row's kc slots hold its best entries by (count desc, id asc), exactly
// as the reference's extraction orders them, and slots past the row's valid
// entries are -1 / -1.  The result is exact and the same on every run: nothing
// depends on the order in which lanes or warps run.
//
// What bounds it on an H100: latency, not throughput.  A row of TN = 2048
// entries is two passes of 64 warp steps (a shared-memory read and a
// __match_any_sync each) plus two scans of nbins / 32 bins; a warp has no
// other work meanwhile, so the caller gives every warp several rows and keeps
// the count tile narrow (one byte a count where the counts allow) so that
// more query rows share one staged data tile.
//
// The row is a template on the count type T (int, uint16_t, uint8_t): an entry
// whose count, read as an int, is not in [0, nbins) must not enter (-1 in an
// int tile, the type's largest value in a narrow one, whose nbins is below
// it -- e.g. a data row past the end of the corpus).  The caller hands in the
// row, the global id of its first entry, and `hist`: nbins ints of scratch
// that are zero on entry and are left zero on return (shared memory, or device
// memory where the bins do not fit).  Only the calling warp may touch `hist`
// meanwhile.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

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

// Pass 1 -- whole warp, converged: add the row's valid counts (tn entries,
// shared memory) to `hist`.
template <typename T>
__device__ inline void warp_histogram(const T* __restrict__ row, int tn, int* hist,
                                      int nbins) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < tn; base += 32) {
    const int i = base + lane;
    const int c = i < tn ? (int)row[i] : -1;
    const bool valid = (unsigned)c < (unsigned)nbins;
    const unsigned peers = __match_any_sync(kFullMask, valid ? c : -1);
    // one leader per distinct count: plain adds do not collide
    if (valid && lane == __ffs(peers) - 1) hist[c] += __popc(peers);
    __syncwarp();
  }
}

// Passes 2 to 4 -- whole warp, converged: `hist` holds the histogram of the
// row's valid counts (from warp_histogram, or built by the caller); ids of the
// row's entries are gid0 + i.  Writes kc slots to out_ids / out_cnt and leaves
// `hist` zero.
template <typename T>
__device__ inline void warp_topk_from_histogram(const T* __restrict__ row, int tn,
                                                long long gid0, int* hist, int nbins,
                                                int kc, int* __restrict__ out_ids,
                                                int* __restrict__ out_cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;

  // 2. threshold: bins are scanned from the top in chunks of 32 (lane 0 holds
  // the chunk's highest bin); `above` counts the entries above the chunk
  int t = 0;
  int n_at_least_t = 0;     // #{count >= t}
  bool found = false;
  int above = 0;
  for (int top = nbins - 1; top >= 0 && !found; top -= 32) {
    const int b = top - lane;
    const int h = b >= 0 ? hist[b] : 0;
    const int incl = warp_inclusive_scan(h);
    const int at_least = above + incl;                  // #{count >= b}
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

  // 3. first slot of every count c >= t: #{count > c}
  int run = 0;
  for (int top = nbins - 1; top >= t; top -= 32) {
    const int b = top - lane;
    const bool in = b >= t;
    const int h = in ? hist[b] : 0;
    const int incl = warp_inclusive_scan(h);
    __syncwarp();
    if (in) hist[b] = run + incl - h;
    run += __shfl_sync(kFullMask, incl, 31);
  }
  __syncwarp();

  // 4. ordered pass in id order
  for (int base = 0; base < tn; base += 32) {
    const int i = base + lane;
    const int c = i < tn ? (int)row[i] : -1;
    const bool take = c >= t && c < nbins;
    if (!__ballot_sync(kFullMask, take)) continue;       // nothing at or above t here
    const unsigned peers = __match_any_sync(kFullMask, take ? c : -1);
    int slot = 0;
    if (take) slot = hist[c] + __popc(peers & lower);
    __syncwarp();
    if (take) {
      if (slot < kc) {
        out_ids[slot] = (int)(gid0 + i);
        out_cnt[slot] = c;
      }
      // the group's highest lane moves the count's next slot past the group
      if (lane == 31 - __clz(peers)) hist[c] += __popc(peers);
    }
    __syncwarp();
  }

  // exhausted slots, then leave the scratch zero for the next row
  for (int s = min(kc, n_at_least_t) + lane; s < kc; s += 32) {
    out_ids[s] = -1;
    out_cnt[s] = -1;
  }
  for (int b = lane; b < nbins; b += 32) hist[b] = 0;
  __syncwarp();
}

// The four passes: the per-tile top-kc of one row, `hist` zero on entry and
// on return.
template <typename T>
__device__ inline void warp_local_topk(const T* __restrict__ row, int tn,
                                       long long gid0, int* hist, int nbins,
                                       int kc, int* __restrict__ out_ids,
                                       int* __restrict__ out_cnt) {
  warp_histogram(row, tn, hist, nbins);
  warp_topk_from_histogram(row, tn, gid0, hist, nbins, kc, out_ids, out_cnt);
}

}  // namespace repro
