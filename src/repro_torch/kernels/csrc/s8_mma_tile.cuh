// The int8 tensor-core tile shared by the COSINE and IP kernels
// (cosine_count.cu, ip_count.cu):
//
//     dot[q, n] = sum_v query[q, v] * data[n, v]     int8 [Q, V] x [N, V] -> int32
//
// and out[q, n] = E::apply(dot[q, n], V), where the epilogue E is the one
// thing the two engines do differently: COSINE writes the sign agreements
// (V + dot) >> 1, IP the dot itself.  The s8 x s8 products are summed in s32
// by the tensor cores, exactly for any int8 values up to V = 2**17.
//
// The product runs on Hopper's warpgroup MMA, wgmma.mma_async m64n256k32
// .s32.s8.s8, which takes 8-bit operands only K-major: the query tile [128, V]
// is A, the data tile [256, V] is B, both read from shared memory through
// matrix descriptors with a 128-byte swizzle.  V is the K loop inside the
// block and the accumulator stays in registers, where the TPU kernel carried
// it across a sequential grid axis.  A block is persistent (one per SM) and
// takes the output tiles [128 queries, 256 data rows] t = block + i * blocks,
// query tiles fastest, so that the blocks in flight share a data tile in L2.
// It holds
//   - two consumer warpgroups, each 64 query rows x 256 data rows of int32
//     accumulators in registers (128 a thread), which run four k32 wgmma per
//     128-byte step of V and then write their rows;
//   - one producer warpgroup, which fills a ring of STAGES 48 KB stages of
//     [128 + 256 rows, 128 bytes] ahead of them, through one of two loaders
//     that write the same swizzled layout:
//       TMA (cp.async.bulk.tensor + mbarrier complete_tx), when V is a
//       multiple of 16 and both base pointers are 16-byte aligned (TMA's
//       stride rule); TMA fills rows past Q or N and bytes past V with 0;
//       registers, for every other V (COSINE's V = 238 gives rows that are
//       only 2-byte aligned, which TMA and cp.async refuse): a thread reads
//       the aligned 32-bit words of its 16-byte pieces with predicated loads,
//       eight pieces in flight, funnel-shifts them into place, zeroes what
//       lies past V or the last row and stores them swizzled;
//       fence.proxy.async then makes the stores visible to the tensor cores.
//     The loader is chosen by the C entry from V and the two pointers, never
//     because the other failed.
// Full and empty mbarriers per stage hand the stages over; the producer runs
// on into the next tile while the consumers write the last one, so one
// tile's epilogue overlaps the next tile's loads.  When V takes 1, 2 or 4
// steps, the grid is a multiple of the query tiles: a block keeps one query
// tile, a stage always holds the same step of V, and its query part is
// loaded once.  A wait that never ends (a fault in the hand-over) traps
// after ~20 s instead of hanging the card.
//
// The epilogue stages each warp's 16 rows through shared memory, 32 columns
// a pass, and stores whole 32-byte sectors of a row with int2 stores: a row
// of the [Q, N] output need not start on a sector (SIFT's N = 281,250 rows
// are 8-byte aligned), and stores that fill sectors only in part took about
// twice the memory time.  Odd N falls back to scalar stores.
//
// What bounds the two uses on an H100: IP at Tweets' segment (Q=1024,
// N=62,500, V=8192), the 1.05e12 int8 operations at 1,979 TOP/s, 0.53 ms;
// COSINE at SIFT's segment (N=281,250, V=238), the 1.15 GB count write at
// 3.35 TB/s, 0.34 ms.  Measured times are in PERF.md.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

namespace repro {
namespace s8_mma_tile {

constexpr int BM = 128;                     // query rows per tile
constexpr int BN = 256;                     // data rows per tile (wgmma N)
constexpr int BK = 128;                     // bytes of V per stage: 4 x k32, one swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK;            // 16 KB
constexpr int B_BYTES = BN * BK;            // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int ACC = BN / 2;                 // int32 accumulators per consumer thread
constexpr int EP_COLS = 32;                 // columns a warp stages per epilogue pass
constexpr int EP_LD = 8 + EP_COLS;          // 8 columns carried over + one pass
constexpr int EP_BYTES = CONSUMERS * 4 * 16 * EP_LD * 4;   // one [16, EP_LD] per warp
constexpr int BAR_BYTES = 2 * STAGES * 8;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + BAR_BYTES + EP_BYTES + 1024;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");

struct Params {
  const int8_t* data;
  const int8_t* query;
  int* out;
  long long n_data;
  long long n_tiles;
  int n_query;
  int v;
  int n_qtiles;
  int k_steps;
  int pair_stores;                          // out rows 8-byte aligned: int2 stores
  int reuse_query;                          // a stage's query part stays in place
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `parity` has completed; trap after ~20 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 40000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col,
                                         int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// K-major, 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart
// (SBO); the leading offset is unused for this layout.  Advancing the start
// address by 32 bytes selects the next k32 slice inside the swizzled row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 256] (+)= A[64 x 32] * B[256 x 32]^T, s8 x s8 -> s32
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[ACC], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// *p when `pred`, else 0, as one predicated load (no branch: the lanes of a
// warp differ in how many words their piece touches).
__device__ __forceinline__ uint32_t load_word_if(const uint32_t* p, int pred) {
  uint32_t x;
  asm("{\n"
      ".reg .pred q;\n"
      "setp.ne.b32 q, %2, 0;\n"
      "mov.b32 %0, 0;\n"
      "@q ld.global.nc.u32 %0, [%1];\n"
      "}\n"
      : "=r"(x)
      : "l"(p), "r"(pred));
  return x;
}

// The register loader, for one part of a stage: ROWS rows (16 apart) of a
// row-major int8 [rows, v] matrix from `row`, the 16-byte piece at column
// `col` of each (its nv bytes inside the row; none when col >= v), stored
// swizzled from `dst` on, 2048 bytes (16 rows of 128) apart.  The thread's
// pieces all start at the same offset from a 4-byte boundary (16 * v is a
// multiple of 4), so it reads the aligned words a piece touches -- each holds
// one of its bytes -- shifts them by one amount and zeroes what lies past V
// or past the last row.  The loads of 8 pieces are issued before any is used.
template <int ROWS>
__device__ __forceinline__ void stage_rows(const int8_t* src, long long row, long long rows,
                                           int v, int col, uint8_t* dst) {
  const int nv = min(16, v - col);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src + row * (long long)v + col);
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const int lead = (int)(a & 3);
  const int words = nv > 0 ? (lead + nv + 3) >> 2 : 0;
  const long long step = 4 * (long long)v;    // 16 rows, in words
  uint32_t mask[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int valid = nv - 4 * k;
    mask[k] = valid >= 4 ? ~0u : (valid <= 0 ? 0u : (1u << (8 * valid)) - 1u);
  }
#pragma unroll
  for (int b = 0; b < ROWS; b += 8) {
    uint32_t x[8][5];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int ok = row + 16 * (b + u) < rows;
      const uint32_t* w = w0 + (b + u) * step;
#pragma unroll
      for (int k = 0; k < 5; ++k) x[u][k] = load_word_if(w + k, ok && k < words);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint4 y;
      y.x = __funnelshift_r(x[u][0], x[u][1], 8 * lead) & mask[0];
      y.y = __funnelshift_r(x[u][1], x[u][2], 8 * lead) & mask[1];
      y.z = __funnelshift_r(x[u][2], x[u][3], 8 * lead) & mask[2];
      y.w = __funnelshift_r(x[u][3], x[u][4], 8 * lead) & mask[3];
      *reinterpret_cast<uint4*>(dst + (b + u) * 16 * BK) = y;
    }
  }
}

// The register loader: one stage, [BM query rows | BN data rows] x BK bytes
// from column k0, by the producer warpgroup's 128 threads: thread tid takes
// piece tid % 8 of rows tid / 8 + 16 u, stored in the 128-byte swizzle TMA
// would write (piece c of row r at piece c ^ (r % 8)).  `with_query`: the
// stage's query part is not already in place.
__device__ __forceinline__ void stage_by_registers(const Params& p, uint8_t* sa, uint8_t* sb,
                                                   int q0, long long n0, int k0, int tid,
                                                   bool with_query) {
  const int c = tid & 7;
  const int r = tid >> 3;
  const int offset = r * BK + ((c ^ (r & 7)) << 4);
  if (with_query) stage_rows<BM / 16>(p.query, q0 + r, p.n_query, p.v, k0 + 16 * c, sa + offset);
  stage_rows<BN / 16>(p.data, n0 + r, p.n_data, p.v, k0 + 16 * c, sb + offset);
}

// The body of a kernel launched with THREADS threads and SMEM_BYTES of
// dynamic shared memory per block, at most one block per SM (see launch).
template <class E, bool kTma>
__device__ __forceinline__ void dot_tile(const Params& p, const CUtensorMap* map_q,
                                         const CUtensorMap* map_d) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // stages 1024-byte aligned, as the 128-byte swizzle's atoms require
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + STAGES * STAGE_BYTES;   // full[s], then empty[s]
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, kTma ? 1 : 128);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer warpgroup
    const int tid = threadIdx.x - CONSUMERS * 128;
    if (kTma && tid != 0) return;
    uint32_t it = 0;
    for (long long t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const int q0 = (int)(t % p.n_qtiles) * BM;      // query tiles fastest
      const long long n0 = (t / p.n_qtiles) * BN;
      for (int ks = 0; ks < p.k_steps; ++ks, ++it) {
        const int s = it % STAGES;
        const uint32_t phase = (it / STAGES) & 1;
        const uint32_t full = bars + 8 * s, empty = bars + 8 * (STAGES + s);
        const uint32_t sa = base + s * STAGE_BYTES;
        // the block's query tile is fixed and this stage always holds the
        // same step of V: its query part is in place after the first round
        const bool with_query = !(p.reuse_query && it >= STAGES);
        mbar_wait(empty, phase ^ 1);
        if (kTma) {
          mbar_expect_tx(full, with_query ? STAGE_BYTES : B_BYTES);
          if (with_query) tma_load(sa, map_q, ks * BK, q0, full);
          tma_load(sa + A_BYTES, map_d, ks * BK, (int)n0, full);
        } else {
          uint8_t* a = smem + s * STAGE_BYTES;
          stage_by_registers(p, a, a + A_BYTES, q0, n0, ks * BK, tid, with_query);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  // consumer warpgroups: query rows 64 * wg .. 64 * wg + 63 of the tile
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  int* scratch = reinterpret_cast<int*>(smem + STAGES * STAGE_BYTES + BAR_BYTES) +
                 (wg * 4 + warp) * 16 * EP_LD;
  uint32_t it = 0;
  for (long long t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const int q0 = (int)(t % p.n_qtiles) * BM;
    const long long n0 = (t / p.n_qtiles) * BN;
    int acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0;
    uint32_t prev_empty = 0;
    for (int ks = 0; ks < p.k_steps; ++ks, ++it) {
      const int s = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      mbar_wait(bars + 8 * s, phase);
      const uint32_t sa = base + s * STAGE_BYTES;
      const uint64_t da = smem_desc(sa + wg * 64 * BK);
      const uint64_t db = smem_desc(sa + A_BYTES);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_m64n256k32(acc, da + 2 * kk, db + 2 * kk, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (ks > 0) {
        // the previous step's products are done: hand its stage back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (lane == 0) mbar_arrive(prev_empty);
      }
      prev_empty = bars + 8 * (STAGES + s);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (p.k_steps > 0 && lane == 0) mbar_arrive(prev_empty);

    // epilogue, in passes of EP_COLS columns: d[4j + 2h + e] is row
    // lane / 4 + 8h of the warp's 16, column 8j + 2 * (lane % 4) + e of the
    // 256.  A pass stages its columns in the warp's scratch behind the last 8
    // of the pass before, and a row then stores the 32 columns that fill
    // whole 32-byte sectors of the output: a [Q, N] row starts at any 8-byte
    // boundary (N = 281,250), and sectors written in part cost about twice
    // the memory time.  Scratch column c holds tile column 32 * pass - 8 + c.
    const int v = p.v;
    const long long row0 = q0 + wg * 64 + warp * 16;
#pragma unroll
    for (int pass = 0; pass < BN / EP_COLS; ++pass) {
#pragma unroll
      for (int jj = 0; jj < EP_COLS / 8; ++jj) {
        const int j = pass * (EP_COLS / 8) + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(scratch + (lane / 4 + 8 * h) * EP_LD + 8 + 8 * jj +
                                   2 * (lane % 4)) =
              make_int2(E::apply(acc[4 * j + 2 * h], v), E::apply(acc[4 * j + 2 * h + 1], v));
      }
      __syncwarp();
      // rows 2i and 2i + 1, 16 lanes each; the last pass also stores the
      // 8 - b columns past its sectors, 4 lanes to a row
      const bool last = pass == BN / EP_COLS - 1;
#pragma unroll
      for (int i = 0; i < (last ? 10 : 8); ++i) {
        const bool tail = i >= 8;
        const int rr = tail ? 8 * (i - 8) + lane / 4 : 2 * i + lane / 16;
        const long long q = row0 + rr;
        // b: the first scratch column whose output address is 32-byte aligned
        const int b = (int)((-(q * p.n_data + n0)) & 7);
        const int sc = tail ? EP_COLS + b + 2 * (lane % 4) : b + 2 * (lane % 16);
        const long long n = n0 + EP_COLS * pass - 8 + sc;
        if (q >= p.n_query || n + 1 < n0 || sc >= EP_LD) continue;
        int* dst = p.out + q * p.n_data + n;
        const int* src = scratch + rr * EP_LD + sc;
        if (p.pair_stores && n >= n0 && n + 1 < p.n_data) {
          *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
        } else {                  // N odd: b is odd, and a pair may straddle n0
          if (n >= n0 && n < p.n_data) dst[0] = src[0];
          if (n + 1 < p.n_data && sc + 1 < EP_LD) dst[1] = src[1];
        }
      }
      __syncwarp();
      // carry the pass's last 8 columns to the front
#pragma unroll
      for (int e = lane; e < 16 * 8; e += 32)
        scratch[(e / 8) * EP_LD + e % 8] = scratch[(e / 8) * EP_LD + EP_COLS + e % 8];
      __syncwarp();
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links the runtime only).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A row-major int8 [rows, v] matrix as a TMA map of [box_rows, BK] boxes,
// 128-byte swizzled, out-of-bounds elements read as 0.
inline bool make_map(CUtensorMap* map, const void* ptr, long long rows, int v, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)v, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)v};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 1 when the operands go through TMA (V a multiple of 16, both base pointers
// 16-byte aligned), 0 when through the register loader.
inline int uses_tma(const void* data, const void* query, int v) {
  return v > 0 && v % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(query) % 16 == 0;
}

typedef void (*Kernel)(const Params, const CUtensorMap, const CUtensorMap);

// Launch one of the two instantiations of a kernel wrapping dot_tile<E, .>
// (the loader chosen by uses_tma) over at most one persistent block per SM on
// `stream`; does not synchronise.  Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for shapes the tile does not take.
template <class E>
inline int launch(Kernel tma_kernel, Kernel reg_kernel, const void* data, const void* query,
                  void* out, long long n_data, int n_query, int v, void* stream) {
  if (n_data <= 0 || n_query <= 0 || v < 0 || n_data > 2147483647LL - BN)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    for (Kernel k : {tma_kernel, reg_kernel}) {
      const cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (err != cudaSuccess) return (int)err;
    }
    configured = true;
  }
  Params p;
  p.data = (const int8_t*)data;
  p.query = (const int8_t*)query;
  p.out = (int*)out;
  p.n_data = n_data;
  p.n_query = n_query;
  p.v = v;
  p.n_qtiles = (n_query + BM - 1) / BM;
  p.n_tiles = (long long)p.n_qtiles * ((n_data + BN - 1) / BN);
  p.k_steps = (v + BK - 1) / BK;
  p.pair_stores = n_data % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const bool tma = uses_tma(data, query, v) != 0;
  CUtensorMap map_q, map_d;
  memset(&map_q, 0, sizeof(map_q));
  memset(&map_d, 0, sizeof(map_d));
  if (tma && !(make_map(&map_q, query, n_query, v, BM) && make_map(&map_d, data, n_data, v, BN)))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // Blocks take the tiles t = block + i * blocks.  When `blocks` is a
  // multiple of the query tiles, a block keeps one query tile; when besides
  // the steps of V divide the ring, a stage always holds the same step and
  // its query part need not be loaded again (COSINE: V = 238 is 2 steps).
  long long blocks = p.n_tiles < sms ? p.n_tiles : sms;
  const long long n_ntiles = p.n_tiles / p.n_qtiles;
  p.reuse_query = 0;
  if (p.k_steps > 0 && STAGES % p.k_steps == 0 && p.n_qtiles <= sms) {
    const long long per_qtile = sms / p.n_qtiles < n_ntiles ? sms / p.n_qtiles : n_ntiles;
    blocks = p.n_qtiles * per_qtile;
    p.reuse_query = 1;
  }
  const Kernel kernel = tma ? tma_kernel : reg_kernel;
  kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(p, map_q, map_d);
  return (int)cudaGetLastError();
}

}  // namespace s8_mma_tile
}  // namespace repro
