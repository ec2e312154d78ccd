// COSINE match-count for Hopper (sm_90a):
//
//     counts[q, n] = (V + sum_v query[q, v] * data[n, v]) >> 1     int32 [Q, N]
//
// over sign vectors int8 [N, V] / [Q, V] with values in {-1, 0, +1} (zero rows
// are the engine's pad fill and give V // 2, as the reference's floor
// division does).
//
// Replaces the TPU kernel `_cosine_kernel` / `cosine_count_pallas`
// (src/repro/kernels/cosine_count.py).  That kernel casts the signs to bf16,
// multiplies [128, 512] x [512, 256] blocks on the MXU in float32 and carries
// an int32 accumulator across a third, sequential grid axis over V; its
// wrapper pads Q, N and V up to the tiles.  Here the signs stay int8 as they
// are stored and go through the int8 tensor-core tile of s8_mma_tile.cuh (a
// [128, 256] output tile per step of a persistent block, wgmma s8 x s8 -> s32
// with V as the K loop, ragged edges zero-filled by the loaders), whose
// epilogue here turns the dot into sign agreements.  IP (ip_count.cu) is the
// same tile with the dot as its epilogue.
//
// What bounds it on an H100: 2*Q*N*V integer operations (1.37e11 at Q=1024,
// N=281250, V=238) against a 1.15 GB count write.  At the int8 tensor-core
// rate the operations take 0.07 ms and the write 0.34 ms, so the write is the
// bound: V = 238 is two 128-byte K steps, and the epilogue's int2 stores are
// nearly all of the work.  V = 238 rows are only 2-byte aligned, so the
// operands go through the tile's register loader.
#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_mma_tile.cuh"

namespace {

// |dot| <= V, so V + dot >= 0 and the shift is floor division by 2
struct Agreements {
  __device__ __forceinline__ static int apply(int dot, int v) { return (v + dot) >> 1; }
};

template <bool kTma>
__global__ void __launch_bounds__(repro::s8_mma_tile::THREADS, 1)
cosine_count_kernel(const __grid_constant__ repro::s8_mma_tile::Params p,
                    const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_d) {
  repro::s8_mma_tile::dot_tile<Agreements, kTma>(p, &map_q, &map_d);
}

}  // namespace

// data int8 [n_data, v], query int8 [n_query, v], out int32 [n_query, n_data],
// all contiguous device pointers.  Launches on `stream`, does not synchronise.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the tile does not take.
extern "C" int repro_cosine_count(const void* data, const void* query, void* out,
                                  long long n_data, int n_query, int v,
                                  void* stream) {
  return repro::s8_mma_tile::launch<Agreements>(cosine_count_kernel<true>,
                                                cosine_count_kernel<false>, data, query,
                                                out, n_data, n_query, v, stream);
}

// 1 when repro_cosine_count takes these operands through TMA, 0 when through
// the register loader.
extern "C" int repro_cosine_count_loader(const void* data, const void* query, int v) {
  return repro::s8_mma_tile::uses_tma(data, query, v);
}
