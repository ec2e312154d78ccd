// TANIMOTO match-count (minhash sketch collisions) for Hopper (sm_90a):
//
//     counts[q, n] = sum_i (data[n, i] == query[q, i])        int32 [Q, N]
//
// Replaces the TPU kernel `_tanimoto_kernel` / `tanimoto_count_pallas`
// (src/repro/kernels/tanimoto_count.py).  That kernel exists apart from the EQ
// kernel only because FLASH-scale sketches (thousands of minhash functions)
// do not fit VMEM: it makes m a third, accumulating grid axis with 512-column
// slabs, and its wrapper pads Q, N and m with -2 / -1 sentinels.  On Hopper
// the EQ tile (eq_tile.cuh) already streams m through shared memory 32
// columns at a time, so the same tile serves any m; this file gives it its own
// kernel name, so that a profile and the launch counts tell the two engines
// apart.  Edges are masked in the kernel: no sentinel reaches it.
//
// What bounds it on an H100: integer ALU throughput (m compares and m adds per
// output element, eq_tile.cuh), exactly as for the EQ kernel.
#include <cuda_runtime.h>

#include "eq_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::eq_tile::THREADS)
tanimoto_count_kernel(const int* __restrict__ data,
                      const int* __restrict__ query, int* __restrict__ out,
                      long long n_data, int n_query, int m, int n_qtiles) {
  repro::eq_tile::count_tile<repro::eq_tile::IntColumns>(data, query, out, n_data,
                                                         n_query, m, n_qtiles);
}

}  // namespace

// data int32 [n_data, m], query int32 [n_query, m], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the tile grid does not fit one grid dimension.
extern "C" int repro_tanimoto_count(const void* data, const void* query,
                                    void* out, long long n_data, int n_query,
                                    int m, void* stream) {
  return repro::eq_tile::launch<repro::eq_tile::IntColumns>(
      tanimoto_count_kernel, data, query, out, n_data, n_query, m, stream);
}
