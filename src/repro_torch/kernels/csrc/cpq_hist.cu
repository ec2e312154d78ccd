// c-PQ Gate histogram for Hopper (sm_90a):
//
//     hist[q, t] = #{ n : counts[q, n] == t },   t in [0, nbins)   int32 [Q, nbins]
//
// Replaces the TPU kernel `_cpq_hist_kernel` (src/repro/kernels/cpq_hist.py).
// That kernel walks the N axis as a sequential grid dimension and carries the
// histogram in its output block from one grid step to the next, building it
// from a [TQ, TN, nbins] one-hot.  Blocks on a GPU run in no order and share
// nothing, so here a block owns a range of one query row: a whole row where
// the query rows fill the card, whose histogram it then writes with plain
// stores, else a chunk of it, whose bins it adds into an output the entry
// point zeroes first.  A count outside [0, nbins) -- the -1 that the
// executor's pad mask writes -- matches no bin.  Integer adds commute, so the
// result is exact and the same on every run.
//
// What bounds it on an H100: bytes.  The function reads Q*N*4 bytes once and
// writes Q*nbins*4 (0.344 ms at Q=1024, N=281250), one add per element.  What
// the design does about it:
//   - bytes in flight: each thread keeps LOADS 16-byte loads in flight (the
//     next step's, issued before it bins the current one), 32 KB an SM at one
//     block of 256 threads; a range is peeled to a 16-byte boundary (a row of
//     [Q, N] starts 16-byte aligned only when N is a multiple of 4);
//   - skew: match counts pile into a few bins (Adult, DBLP, Tweets: four bins
//     hold most of a row), so lanes adding into one shared histogram would
//     serialise on the same address.  Where they fit (nbins <= 453), every
//     thread has private counters instead: 16 bits a bin, bins 2p and 2p + 1
//     in the two halves of word p of the thread's column, which lies in its
//     own bank; an element is one conflict-free shared atomic add (1 or
//     1 << 16), with no __match_any_sync and no branch: a count outside the
//     bins adds into a dummy bin nbins, which is never read.  A thread counts
//     at most 65,506 elements between two flushes, so a half never carries
//     into the other.
//     The flush sums the threads' columns bin by bin (one warp a word row,
//     __reduce_add_sync).  Wider histograms (up to 58,112 bins, all of a
//     block's shared memory) share one int32 copy a block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 8;                          // 16-byte loads a thread a step
constexpr long long STEP = THREADS * LOADS;       // int4 groups a block a step
// steps between two flushes of the private counters: 2047 * 32 = 65,504
// elements a thread, and at most two more from the range's ragged ends
constexpr int FLUSH_STEPS = 65535 / (4 * LOADS);
constexpr int MAX_SMEM = 232448;                  // 227 KB: the most a block may ask
constexpr long long MIN_CHUNK = 4 * STEP * 4;    // counts a chunk, at least: four steps

// Shared memory of a block: private counters (bins 0 .. nbins, the last the
// dummy: nbins / 2 + 1 words a thread), or one int32 copy of the bins.
bool private_bins(int nbins) { return (long long)(nbins / 2 + 1) * THREADS * 4 <= MAX_SMEM; }
int smem_bytes(int nbins) {
  return (int)(private_bins(nbins) ? (long long)(nbins / 2 + 1) * THREADS * 4 : nbins * 4LL);
}

// A block counts [start, end) of one query row.  Where a row is cut into
// chunks (n_chunks > 1), its bins are added into the zeroed output.
// PRIVATE: per-thread 16-bit counters, else one int32 copy of the bins.
template <bool PRIVATE>
__global__ void __launch_bounds__(THREADS)
cpq_hist_kernel(const int* __restrict__ counts, int* __restrict__ hist, long long n,
                int nbins, long long chunk, int n_chunks) {
  extern __shared__ unsigned h[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long q = blockIdx.x / n_chunks;
  const long long start = (long long)(blockIdx.x % n_chunks) * chunk;
  const long long end = min(start + chunk, n);
  const bool chunked = n_chunks > 1;
  int* __restrict__ out = hist + q * nbins;
  const int words = PRIVATE ? nbins / 2 + 1 : 0;         // with the dummy bin

  // private: thread t's counters are column t of [words][THREADS], touched by
  // no other thread until the flush; shared: one copy of the bins
  if (PRIVATE) {
    for (int p = 0; p < words; ++p) h[p * THREADS + t] = 0u;
  } else {
    for (int b = t; b < nbins; b += THREADS) h[b] = 0u;
    __syncthreads();
  }
  auto add = [&](int v) {
    if (PRIVATE) {
      const unsigned b = min((unsigned)v, (unsigned)nbins);        // else the dummy bin
      atomicAdd(&h[(b >> 1) * THREADS + t], (b & 1u) ? 0x10000u : 1u);
    } else if ((unsigned)v < (unsigned)nbins) {
      atomicAdd(&h[v], 1u);
    }
  };
  // the block's bins into the output: stored on the first flush of a whole
  // row, added after (the same thread handles a bin every time), or added by
  // atomics into the zeroed output of a chunked row
  bool first = true;
  auto flush = [&](bool more) {
    __syncthreads();
    if (PRIVATE) {
      for (int p = warp; p < words; p += WARPS) {
        unsigned lo = 0, hi = 0;
        for (int j = lane; j < THREADS; j += 32) {
          const unsigned x = h[p * THREADS + j];
          lo += x & 0xffffu;
          hi += x >> 16;
        }
        lo = __reduce_add_sync(0xffffffffu, lo);
        hi = __reduce_add_sync(0xffffffffu, hi);
        const int b = 2 * p + lane;
        if (lane < 2 && b < nbins) {
          const int v = (int)(lane ? hi : lo);
          if (chunked) {
            if (v) atomicAdd(out + b, v);
          } else {
            out[b] = first ? v : out[b] + v;
          }
        }
      }
    } else {
      for (int b = t; b < nbins; b += THREADS) {
        const int v = (int)h[b];
        if (chunked) {
          if (v) atomicAdd(out + b, v);
        } else {
          out[b] = v;
        }
      }
    }
    first = false;
    if (PRIVATE && more) {              // zero the counters for the next span
      __syncthreads();
      for (int p = 0; p < words; ++p) h[p * THREADS + t] = 0u;
    }
  };

  // peel to a 16-byte boundary, then int4 groups, then the ragged tail
  const int* __restrict__ row = counts + q * n + start;
  const long long len = end - start;
  const long long head = min(len, (long long)(((16 - ((uintptr_t)row & 15)) & 15) >> 2));
  if (t < head) add(row[t]);
  const int4* __restrict__ v4 = reinterpret_cast<const int4*>(row + head);
  const long long groups = (len - head) >> 2;
  const int tail = (int)((len - head) & 3);

  int4 x[LOADS];
  auto load = [&](long long g0) {
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const long long g = g0 + t + (long long)k * THREADS;
      x[k] = g < groups ? __ldg(v4 + g) : make_int4(-1, -1, -1, -1);
    }
  };
  load(0);
  int steps = 0;
  for (long long g0 = 0; g0 < groups; g0 += STEP) {
    int4 cur[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) cur[k] = x[k];
    load(g0 + STEP);                    // the next step's loads fly while this one is binned
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      add(cur[k].x);
      add(cur[k].y);
      add(cur[k].z);
      add(cur[k].w);
    }
    if (PRIVATE && ++steps == FLUSH_STEPS && g0 + STEP < groups) {
      flush(true);
      steps = 0;
    }
  }
  if (t < tail) add(row[head + 4 * groups + t]);
  flush(false);
}

// The grid for this shape: whole rows (n_chunks = 1) where the query rows
// fill at least half the blocks the card holds at once, else each row cut
// into chunks of at least MIN_CHUNK counts (a multiple of 4) so that about
// as many blocks as the card holds run.
template <bool PRIVATE>
int hist_grid(long long n, int n_query, int nbins, long long* chunk, int* n_chunks) {
  const int smem = smem_bytes(nbins);
  cudaError_t err = cudaFuncSetAttribute(cpq_hist_kernel<PRIVATE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cpq_hist_kernel<PRIVATE>,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long fit = (long long)sms * per_sm;
  long long c = 1;
  if (2LL * n_query < fit) {
    c = (fit + n_query - 1) / n_query;
    const long long most = (n + MIN_CHUNK - 1) / MIN_CHUNK;
    c = c < most ? c : most;
  }
  long long size = (n + c - 1) / c;
  size = (size + 3) / 4 * 4;
  c = (n + size - 1) / size;
  if (c * n_query > 2147483647LL) return (int)cudaErrorInvalidValue;
  *chunk = size;
  *n_chunks = (int)c;
  return 0;
}

template <bool PRIVATE>
int hist_launch(const void* counts, void* hist, long long n, int n_query, int nbins,
                void* stream) {
  long long chunk = 0;
  int n_chunks = 0;
  const int err = hist_grid<PRIVATE>(n, n_query, nbins, &chunk, &n_chunks);
  if (err) return err;
  if (n_chunks > 1) {
    const cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)n_query * nbins * sizeof(int),
                                          (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  cpq_hist_kernel<PRIVATE><<<(unsigned)((long long)n_chunks * n_query), THREADS,
                             (size_t)smem_bytes(nbins), (cudaStream_t)stream>>>(
      (const int*)counts, (int*)hist, n, nbins, chunk, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// counts int32 [n_query, n] contiguous, hist int32 [n_query, nbins]
// contiguous (its contents are overwritten: zeroed here first where rows are
// cut into chunks).  Launches on `stream`, does not synchronise.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when the shape
// does not fit (grid dimension, or bins beyond a block's shared memory).
extern "C" int repro_cpq_hist(const void* counts, void* hist, long long n,
                              int n_query, int nbins, void* stream) {
  if (n <= 0 || n_query <= 0 || nbins <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)nbins * 4 > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return private_bins(nbins) ? hist_launch<true>(counts, hist, n, n_query, nbins, stream)
                             : hist_launch<false>(counts, hist, n, n_query, nbins, stream);
}
