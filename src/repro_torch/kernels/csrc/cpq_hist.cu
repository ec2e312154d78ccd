// c-PQ Gate histogram for Hopper (sm_90a):
//
//     hist[q, t] = #{ n : counts[q, n] == t },   t in [0, nbins)   int32 [Q, nbins]
//
// Replaces the TPU kernel `_cpq_hist_kernel` (src/repro/kernels/cpq_hist.py).
// That kernel walks the N axis as a sequential grid dimension and carries the
// histogram in its output block from one grid step to the next, building it
// from a [TQ, TN, nbins] one-hot.  Blocks on a GPU run in no order and share
// nothing, so here one block owns one (query row, N-chunk) pair, fills an
// nbins-entry histogram in shared memory with atomicAdd, and flushes its
// non-zero bins with atomicAdd into the output, which the caller
// zero-initialises.  Integer adds commute, so the result is exact and the same
// on every run.  A count outside [0, nbins) -- the -1 that the executor's pad
// mask writes -- matches no bin.  Bins are not padded.
//
// What bounds it on an H100: bytes.  The function reads Q*N*4 bytes once and
// writes Q*nbins*4; there is one add per element.  What stands in the way of
// the byte bound is contention: match counts are heavily skewed (most objects
// share a few small counts), so the lanes of a warp mostly hit the same bin.
// The design groups equal bins inside the warp with __match_any_sync and lets
// one lane add the group's size, which turns a 32-way serialised atomic into
// one.  Measured on an H100 (700 W) at Q=1024, N=281250, 239 bins: 962 GB/s,
// 29 % of the memory rate.  Times are in PERF.md.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 32;                     // counts per thread per block
constexpr int CHUNK = THREADS * ITEMS;        // counts per block
constexpr int MAX_SMEM = 232448;              // 227 KB: the most a block may ask

__global__ void __launch_bounds__(THREADS)
cpq_hist_kernel(const int* __restrict__ counts, int* __restrict__ hist,
                long long n, int nbins, int n_chunks) {
  extern __shared__ int h[];
  for (int i = threadIdx.x; i < nbins; i += THREADS) h[i] = 0;
  __syncthreads();

  const long long q = blockIdx.x / n_chunks;
  const long long start = (long long)(blockIdx.x % n_chunks) * CHUNK;
  const long long end = min(start + CHUNK, n);
  const int* __restrict__ row = counts + q * n;
  const int lane = threadIdx.x & 31;

  // `base` is the same for every thread, so whole warps stay in the loop and
  // __match_any_sync may name the full mask
  for (long long base = start; base < end; base += THREADS) {
    const long long i = base + threadIdx.x;
    int bin = -1;
    if (i < end) {
      const int v = row[i];
      if ((unsigned)v < (unsigned)nbins) bin = v;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&h[bin], __popc(peers));
  }
  __syncthreads();

  int* __restrict__ out = hist + q * nbins;
  for (int i = threadIdx.x; i < nbins; i += THREADS) {
    const int v = h[i];
    if (v != 0) atomicAdd(&out[i], v);
  }
}

}  // namespace

// counts int32 [n_query, n] contiguous, hist int32 [n_query, nbins] contiguous
// and already zero.  Launches on `stream`, does not synchronise.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue when the shape
// does not fit (grid dimension, or a histogram larger than a block's shared
// memory).
extern "C" int repro_cpq_hist(const void* counts, void* hist, long long n,
                              int n_query, int nbins, void* stream) {
  if (n <= 0 || n_query <= 0 || nbins <= 0) return (int)cudaErrorInvalidValue;
  const long long smem = (long long)nbins * (long long)sizeof(int);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  const long long blocks = n_chunks * n_query;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cpq_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cpq_hist_kernel<<<(unsigned)blocks, THREADS, (size_t)smem,
                    (cudaStream_t)stream>>>(
      (const int*)counts, (int*)hist, n, nbins, (int)n_chunks);
  return (int)cudaGetLastError();
}
