"""TANIMOTO match-count (minhash sketch collisions): the CUDA kernel's wrapper
and its plain PyTorch version.

    counts[q, n] = sum_i (data_sigs[n, i] == query_sigs[q, i])     int32 [Q, N]

Replaces the TPU kernel `_tanimoto_kernel` / `tanimoto_count_pallas`
(`src/repro/kernels/tanimoto_count.py`), which streams the signature axis m
through a third grid axis because FLASH-scale sketches do not fit VMEM.  The
kernel is `csrc/tanimoto_count.cu`: the equality tile of `csrc/eq_tile.cuh`
(the EQ kernel's) already streams m through shared memory, so it serves any
m.  Minhash bucket ids lie in [0, n_buckets), below 31744, so every chunk is
compared as float16 lanes, two columns per HSET2, exact because those int16
bit patterns are distinct finite float16 values; the lanes are added into
int32 every 4096 columns, so FLASH-scale m stays exact.  Ids outside that
range take the tile's general int32 path in the same launch.

`tanimoto_count` launches the kernel for CUDA tensors and raises when it
cannot; it takes `tanimoto_count_plain` only for tensors that lie on the CPU.

The kernel is compiled in two block shapes of the equality tile, which the
knob tile_q picks (`common.pick_variant`): 128 query rows a block (the
default) and 32, which a batch of at most 32 queries takes by default, as
the reference's `pick_tile` clamps its tile to Q.  Both count 128 data rows
a block (tile_n and tile_m, the 32-column chunk of the signature axis, have one
shape).
"""
from __future__ import annotations

import torch

from repro_torch.core.match import match_tanimoto
from repro_torch.kernels import common

# The plain PyTorch version of this kernel is the engine's reference
# semantics, `core.match.match_tanimoto`, bound here under the kernel's name
# so the two stand side by side.
tanimoto_count_plain = match_tanimoto

# the block shapes each knob selects (csrc/eq_tile.cuh: eq::Narrow, eq::Wide),
# and the C entry of each query-row shape
VARIANTS = {"tile_q": (32, 128), "tile_n": (128,), "tile_m": (32,)}
_ENTRY = {32: "tanimoto_count_q32", 128: "tanimoto_count"}


def tanimoto_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor, *,
                   tile_q: int | None = None, tile_n: int | None = None,
                   tile_m: int | None = None) -> torch.Tensor:
    """counts int32 [Q, N] from data int32 [N, m] and queries int32 [Q, m],
    both contiguous and on one device; the tile knobs pick the block shape
    (VARIANTS)."""
    tiles = common.pick_variants(
        VARIANTS, {"tile_q": len(query_sigs), "tile_n": len(data_sigs),
                   "tile_m": query_sigs.shape[-1]},
        {"tile_q": tile_q, "tile_n": tile_n, "tile_m": tile_m})
    if data_sigs.device.type == "cpu" and query_sigs.device.type == "cpu":
        return tanimoto_count_plain(data_sigs, query_sigs)
    n, q, m = common.check_pair("tanimoto_count", data_sigs, query_sigs)
    return common.launch_count("tanimoto_count", data_sigs, query_sigs, n, q, m,
                               entry=_ENTRY[tiles["tile_q"]],
                               variant=f"tile_q={tiles['tile_q']}")


def smem_bytes(tiles: dict, width: int) -> int:
    """Shared memory a block of the shape `tiles` (from VARIANTS) takes."""
    return common.eq_tile_smem(tiles["tile_q"])
