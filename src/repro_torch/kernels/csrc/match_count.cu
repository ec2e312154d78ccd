// EQ match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])        int32 [Q, N]
//
// Replaces the TPU kernel `_match_count_kernel`
// (src/repro/kernels/match_count.py).  That kernel holds a [128, m] query
// block and a [256, m] data block in VMEM and folds m eight columns at a time
// on the vector unit; its wrapper pads Q and N up to the tile with -2 / -1
// sentinels.  Here the tile of eq_tile.cuh does the work: a thread block owns
// one [128, 128] tile of the output, walks m in chunks staged through shared
// memory, and every thread keeps an 8 x 8 register micro-tile of int32
// accumulators.  Ragged edges are masked in the kernel, so nothing is padded
// or copied and the output is exactly [Q, N].
//
// What bounds it on an H100: integer ALU throughput, not memory (eq_tile.cuh
// counts it).  Measured on an H100 (700 W) at Q=1024, N=281250, m=238:
// 4.8e12 compare-accumulates a second while moving 100 GB/s, 3 % of the
// memory rate -- so it is the integer instruction rate that binds, as
// expected.  Times are in PERF.md.
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::eq_tile::THREADS)
match_count_kernel(const int* __restrict__ data, const int* __restrict__ query,
                   int* __restrict__ out, long long n_data, int n_query, int m,
                   int n_qtiles) {
  repro::eq_tile::count_tile<repro::eq_tile::IntColumns>(data, query, out, n_data,
                                                         n_query, m, n_qtiles);
}

}  // namespace

// data int32 [n_data, m], query int32 [n_query, m], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the tile grid does not fit one grid dimension.
extern "C" int repro_match_count(const void* data, const void* query, void* out,
                                 long long n_data, int n_query, int m,
                                 void* stream) {
  return repro::eq_tile::launch<repro::eq_tile::IntColumns>(
      match_count_kernel, data, query, out, n_data, n_query, m, stream);
}
