// EQ match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])        int32 [Q, N]
//
// Replaces the TPU kernel `_match_count_kernel`
// (src/repro/kernels/match_count.py).  That kernel holds a [128, m] query
// block and a [256, m] data block in VMEM and folds m eight columns at a time
// on the vector unit; its wrapper pads Q and N up to the tile with -2 / -1
// sentinels.  Here the equality tile of eq_tile.cuh (count_eq_tile) does the
// work: a block of 512 threads owns one [128, 128] tile of the output (256
// threads and a [32, 128] tile in the Narrow shape that the wrapper picks for
// small query batches, as the reference's pick_tile clamps its tile to Q)
// and walks m in chunks of 32 columns staged through shared memory.  Ragged
// edges are masked in the kernel, so nothing is padded or copied and the
// output is exactly [Q, N].
//
// What bounds it on an H100: the instruction pipes (eq_tile.cuh counts them).
// A compare-and-add on int32 takes three instructions of the 64-lane integer
// pipe, ~21 pairs per SM-clock at best.  A chunk whose ids all lie in
// [0, 31744) -- every bucket id the LSH schemes produce, 8192 buckets by
// default -- is compared as float16 lanes instead: two columns per HSET2 and
// one HADD2, exact because those bit patterns are distinct finite float16
// values, ~86 pairs per SM-clock at best.  Any other chunk takes the general
// path in the same kernel (one ISETP, an HADD2 and a predicated move per
// pair), exact for every int32.  Times and SASS counts are in PERF.md.
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

using repro::eq_tile::eq::Narrow;
using repro::eq_tile::eq::Wide;

// S::MIN_BLOCKS blocks per SM (at most 64 registers a thread): one block
// stages its chunk while another counts
template <class S>
__global__ void __launch_bounds__(S::THREADS, S::MIN_BLOCKS)
match_count_kernel(const int* __restrict__ data, const int* __restrict__ query,
                   int* __restrict__ out, long long n_data, int n_query, int m,
                   int n_qtiles) {
  repro::eq_tile::count_eq_tile(S(), data, query, out, n_data, n_query, m, n_qtiles);
}

}  // namespace

// data int32 [n_data, m], query int32 [n_query, m], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the tile grid does not fit one grid dimension.  repro_match_count: the Wide
// shape, 128 query rows a block; repro_match_count_q32: the Narrow shape, 32.
extern "C" int repro_match_count(const void* data, const void* query, void* out,
                                 long long n_data, int n_query, int m, void* stream) {
  return repro::eq_tile::launch_eq<Wide>(match_count_kernel<Wide>, data, query, out, n_data,
                                         n_query, m, stream);
}

extern "C" int repro_match_count_q32(const void* data, const void* query, void* out,
                                     long long n_data, int n_query, int m, void* stream) {
  return repro::eq_tile::launch_eq<Narrow>(match_count_kernel<Narrow>, data, query, out, n_data,
                                           n_query, m, stream);
}
