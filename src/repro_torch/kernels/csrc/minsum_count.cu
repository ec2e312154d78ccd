// MINSUM match-count for Hopper (sm_90a):
//
//     counts[q, n] = sum_v min(data[n, v], query[q, v])        int32 [Q, N]
//
// over n-gram count vectors int32 [N, V] / [Q, V] (sa/ngram.py: per-bucket
// gram multiplicities, clipped at 127; the engine's pad rows hold -1 and sum
// to a negative count, which the plan masks before selection).
//
// Replaces the TPU kernel `_minsum_kernel` / `minsum_count_pallas`
// (src/repro/kernels/minsum_count.py).  That kernel makes the vocabulary axis
// V a third, accumulating grid axis of 512-column slabs held in VMEM, with an
// int32 scratch accumulator carried from one grid step to the next, and its
// wrapper pads Q, N and V with zeros.  On Hopper there is no sequential grid
// to carry a sum across, and none is needed: the count tile of eq_tile.cuh
// already streams the row axis through shared memory 32 columns at a time
// into an 8 x 8 register micro-tile, so MINSUM is that tile with a policy
// whose slot pair counts min(a, b) instead of a == b (MinColumns).  Ragged
// edges -- rows, columns, V not a multiple of the chunk -- are masked in the
// kernel: nothing is padded on the host.
//
// What bounds it on an H100: integer issue.  Every output element costs V
// minimums and V adds: 2*Q*N*V = 5.2e11 operations per segment of DBLP's
// shape (Q=1024, N=62500, V=4096), 7.8 ms at the 67 T/s non-tensor rate,
// against 1.3 GB of traffic (0.38 ms).  No tensor-core instruction computes a
// minimum.  A sparse form (count vectors hold at most 38 non-zero buckets of
// 4096) would skip most of the work; that is a different kernel (a later PR).
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::eq_tile::THREADS)
minsum_count_kernel(const int* __restrict__ data, const int* __restrict__ query,
                    int* __restrict__ out, long long n_data, int n_query, int v,
                    int n_qtiles) {
  repro::eq_tile::count_tile<repro::eq_tile::MinColumns>(data, query, out, n_data,
                                                         n_query, v, n_qtiles);
}

}  // namespace

// data int32 [n_data, v], query int32 [n_query, v], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the tile grid does not fit one grid dimension.
extern "C" int repro_minsum_count(const void* data, const void* query, void* out,
                                  long long n_data, int n_query, int v,
                                  void* stream) {
  return repro::eq_tile::launch<repro::eq_tile::MinColumns>(
      minsum_count_kernel, data, query, out, n_data, n_query, v, stream);
}
