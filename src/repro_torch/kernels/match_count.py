"""EQ match-count: the CUDA kernel's wrapper and its plain PyTorch version.

    counts[q, n] = sum_i (data_sigs[n, i] == query_sigs[q, i])     int32 [Q, N]

Replaces the TPU kernel `_match_count_kernel` / `match_count_pallas`
(`src/repro/kernels/match_count.py`); the kernel is `csrc/match_count.cu` on
the equality tile of `csrc/eq_tile.cuh`.  GENIE's inverted-index scan,
re-expressed as a dense all-pairs compare: instead of walking postings lists
with atomic counter updates, a block owns a [128, 128] tile of the count
matrix and streams the signature axis through shared memory.

What bounds it on an H100 is the instruction pipes.  A 32-column chunk whose
ids all lie in [0, 31744) -- every bucket id an LSH scheme produces -- is
compared as float16 lanes, two columns per HSET2: those int16 bit patterns are
31,744 distinct finite float16 values with a single zero, so the float16
compare is exact there, and float16 counts are exact up to 2048, so the lanes
are added into int32 every 4096 columns.  Any other chunk takes the tile's
general int32 path in the same launch.  The result is exact int32 for any
int32 input; the kernel picks the path per chunk, with no read-back.

`match_count` launches the kernel for CUDA tensors and raises when it cannot;
it takes `match_count_plain` only for tensors that lie on the CPU.

The kernel is compiled in two block shapes of the equality tile, which the
knob tile_q picks (`common.pick_variant`): 128 query rows a block (the
default) and 32, which a batch of at most 32 queries takes by default, as
the reference's `pick_tile` clamps its tile to Q.  Both count 128 data rows
a block (tile_n has one
shape).
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_eq
from repro_torch.kernels import common

# The plain PyTorch version of this kernel is `core.match.match_eq` (the
# engine's reference semantics, chunked so its temp stays [Q, N, chunk]); it
# is bound here under the kernel's name so the two stand side by side.
match_count_plain = match_eq

# the block shapes each knob selects (csrc/eq_tile.cuh: eq::Narrow, eq::Wide),
# and the C entry of each query-row shape
VARIANTS = {"tile_q": (32, 128), "tile_n": (128,)}
_ENTRY = {32: "match_count_q32", 128: "match_count"}


def match_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor, *,
                tile_q: int | None = None, tile_n: int | None = None) -> torch.Tensor:
    """counts int32 [Q, N] from data int32 [N, m] and queries int32 [Q, m],
    both contiguous and on one device; the tile knobs pick the block shape
    (VARIANTS)."""
    tiles = common.pick_variants(VARIANTS, {"tile_q": len(query_sigs), "tile_n": len(data_sigs)},
                                 {"tile_q": tile_q, "tile_n": tile_n})
    if data_sigs.device.type == "cpu" and query_sigs.device.type == "cpu":
        return match_count_plain(data_sigs, query_sigs)
    n, q, m = common.check_pair("match_count", data_sigs, query_sigs)
    return common.launch_count("match_count", data_sigs, query_sigs, n, q, m,
                               entry=_ENTRY[tiles["tile_q"]],
                               variant=f"tile_q={tiles['tile_q']}")


def smem_bytes(tiles: dict, width: int) -> int:
    """Shared memory a block of the shape `tiles` (from VARIANTS) takes."""
    return common.eq_tile_smem(tiles["tile_q"])

