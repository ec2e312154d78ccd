"""Public entries of the kernel layer: what the GENIE engines call.

The counterpart of `repro/kernels/ops.py`, with an entry for every engine's
kernel and the c-PQ histogram.  The TPU wrappers pad inputs to tile multiples
with sentinels (-1 / -2, 255 / 254 for uint8 buckets, the empty range lo = 1,
hi = 0 for RANGE queries) and slice the result back; the CUDA kernels mask
their ragged edges themselves, so no sentinel reaches them and an entry here
only brings its operands to the form the kernel takes (int32, int8 signs or
word vectors, uint8 buckets, contiguous -- the cast the reference applies,
on every call) and calls the wrapper.  `repro_torch.kernels.ref` holds the oracles.

Every entry takes the tile knobs of the reference's (tile_q / tile_n /
tile_v / tile_m, keyword-only, None = the default).  They select among the
block shapes a kernel was compiled in (`VARIANTS`, through
`common.pick_variant`, which also refuses a value below its alignment floor
as `pick_tile` does): `match_count` / `tanimoto_count` have two query-row
shapes (128, 32) and `packed_cosine_topk` / `packed_tanimoto_topk` two tiles
(2048, 1024 data rows); every other kernel has one shape, which every valid
value selects.  `cpq_hist` takes no knob here, as in the autotuner of the
reference.  The counts are the same whatever shape is picked.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels import cosine_count as _cos
from repro_torch.kernels import cpq_hist as _cpq_hist
from repro_torch.kernels import ip_count as _ip
from repro_torch.kernels import match_count as _mc
from repro_torch.kernels import minsum_count as _ms
from repro_torch.kernels import packed_cosine as _pcos
from repro_torch.kernels import packed_tanimoto as _ptan
from repro_torch.kernels import range_count as _rc
from repro_torch.kernels import tanimoto_count as _tc


def _int32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _int8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int8).contiguous()


def _uint8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8).contiguous()


# kernel -> knob -> the block shapes it was compiled in (sorted ascending)
VARIANTS: dict[str, dict[str, tuple]] = {
    "match_count": _mc.VARIANTS,
    "range_count": {"tile_q": (128,), "tile_n": (128,)},
    # the inverted walk's 32 queries in flight a block (one a warp), its
    # chunks of at most 256 data rows and their index of at most 4096
    # buckets (the dense tile is eq_tile.cuh's 128 x 128)
    "minsum_count": {"tile_q": (32,), "tile_n": (256,), "tile_v": (4096,)},
    # the int8 tensor-core tile of s8_mma_tile.cuh: BM x BN, BK bytes a stage
    "ip_count": {"tile_q": (128,), "tile_n": (256,), "tile_v": (128,)},
    "tanimoto_count": _tc.VARIANTS,
    "cosine_count": {"tile_q": (128,), "tile_n": (256,), "tile_v": (128,)},
    # csrc/packed_cosine.cu, namespace count: 32 query rows, 1024 data rows
    "packed_cosine_count": {"tile_q": (32,), "tile_n": (1024,)},
    "packed_cosine_topk": _pcos.TOPK_VARIANTS,
    # csrc/packed_tanimoto.cu, namespace count: 128 x 128, 32 columns a chunk
    "packed_tanimoto_count": {"tile_q": (128,), "tile_n": (128,), "tile_m": (32,)},
    "packed_tanimoto_topk": _ptan.TOPK_VARIANTS,
}


def variant_smem(kernel: str, tiles: dict, width: int) -> int | None:
    """Shared memory a block of `kernel` in the shape `tiles` (knob ->
    shape, from VARIANTS) asks for at rows of `width` elements, static and
    dynamic; None for a kernel of one shape (never pruned: it is the
    default)."""
    smem = {"match_count": _mc.smem_bytes, "tanimoto_count": _tc.smem_bytes,
            "packed_cosine_topk": _pcos.topk_smem,
            "packed_tanimoto_topk": _ptan.topk_smem}.get(kernel)
    return None if smem is None else smem(tiles, width)


def _check_tiles(kernel: str, sizes: dict, tiles: dict) -> None:
    """Validate the knobs of a kernel of one shape (each selects it)."""
    common.pick_variants(VARIANTS[kernel], sizes, tiles)


def match_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor, *,
                tile_q: int | None = None, tile_n: int | None = None) -> torch.Tensor:
    """EQ engine kernel: counts int32 [Q, N]."""
    return _mc.match_count(_int32(data_sigs), _int32(query_sigs), tile_q=tile_q, tile_n=tile_n)


def range_count(data_vals: torch.Tensor, q_lo: torch.Tensor,
                q_hi: torch.Tensor, *, tile_q: int | None = None,
                tile_n: int | None = None) -> torch.Tensor:
    """RANGE engine kernel: counts int32 [Q, N]."""
    _check_tiles("range_count", {"tile_q": len(q_lo), "tile_n": len(data_vals)},
                 {"tile_q": tile_q, "tile_n": tile_n})
    return _rc.range_count(_int32(data_vals), _int32(q_lo), _int32(q_hi))


def minsum_count(data_cnt: torch.Tensor, query_cnt: torch.Tensor, *,
                 tile_q: int | None = None, tile_n: int | None = None,
                 tile_v: int | None = None) -> torch.Tensor:
    """MINSUM engine kernel: counts int32 [Q, N]."""
    _check_tiles("minsum_count", {"tile_q": len(query_cnt), "tile_n": len(data_cnt),
                                  "tile_v": query_cnt.shape[-1]},
                 {"tile_q": tile_q, "tile_n": tile_n, "tile_v": tile_v})
    return _ms.minsum_count(_int32(data_cnt), _int32(query_cnt))


def ip_count(data_bin: torch.Tensor, query_bin: torch.Tensor, *,
             tile_q: int | None = None, tile_n: int | None = None,
             tile_v: int | None = None) -> torch.Tensor:
    """IP engine kernel: exact int32 counts [Q, N] from binary word vectors
    (any dtype; the kernel takes int8, so other dtypes are cast here on every
    call, as the reference's wrapper casts to bf16)."""
    _check_tiles("ip_count", {"tile_q": len(query_bin), "tile_n": len(data_bin),
                              "tile_v": query_bin.shape[-1]},
                 {"tile_q": tile_q, "tile_n": tile_n, "tile_v": tile_v})
    return _ip.ip_count(_int8(data_bin), _int8(query_bin))


def cpq_hist(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """c-PQ Gate histogram: int32 [Q, max_count + 1]."""
    return _cpq_hist.cpq_hist(_int32(counts), max_count)


def tanimoto_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor, *,
                   tile_q: int | None = None, tile_n: int | None = None,
                   tile_m: int | None = None) -> torch.Tensor:
    """TANIMOTO engine kernel: minhash collision counts int32 [Q, N]."""
    return _tc.tanimoto_count(_int32(data_sigs), _int32(query_sigs), tile_q=tile_q,
                              tile_n=tile_n, tile_m=tile_m)


def cosine_count(data_sgn: torch.Tensor, query_sgn: torch.Tensor, *,
                 tile_q: int | None = None, tile_n: int | None = None,
                 tile_v: int | None = None) -> torch.Tensor:
    """COSINE engine kernel: sign-agreement counts int32 [Q, N] from sign
    vectors in {-1, 0, +1} (zero rows floor to V // 2)."""
    _check_tiles("cosine_count", {"tile_q": len(query_sgn), "tile_n": len(data_sgn),
                                  "tile_v": query_sgn.shape[-1]},
                 {"tile_q": tile_q, "tile_n": tile_n, "tile_v": tile_v})
    return _cos.cosine_count(_int8(data_sgn), _int8(query_sgn))


def packed_cosine_count(data_words: torch.Tensor, query_words: torch.Tensor, *,
                        tile_q: int | None = None, tile_n: int | None = None) -> torch.Tensor:
    """Packed COSINE kernel: XOR+popcount agreement counts int32 [Q, N] from
    the word matrices of core/packing.py (query tail bits 1, data tail 0)."""
    _check_tiles("packed_cosine_count", {"tile_q": len(query_words), "tile_n": len(data_words)},
                 {"tile_q": tile_q, "tile_n": tile_n})
    return _pcos.packed_cosine_count(_int32(data_words), _int32(query_words))


def packed_cosine_topk(data_words: torch.Tensor, query_words: torch.Tensor, *,
                       k: int, tile_q: int | None = None,
                       tile_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused packed COSINE match->count->local-top-k: (ids, counts) int32
    [Q, n_tiles * min(k, tn)] candidate buffers (tn: the tile tile_n picks)
    in per-tile (count desc, id asc) order; ids are object ids, empty slots
    are -1 / -1."""
    return _pcos.packed_cosine_topk(_int32(data_words), _int32(query_words), k,
                                    tile_q=tile_q, tile_n=tile_n)


def packed_tanimoto_count(data_u8: torch.Tensor, query_u8: torch.Tensor, *,
                          tile_q: int | None = None, tile_n: int | None = None,
                          tile_m: int | None = None) -> torch.Tensor:
    """Packed TANIMOTO kernel: byte-lane collision counts int32 [Q, N]."""
    _check_tiles("packed_tanimoto_count", {"tile_q": len(query_u8), "tile_n": len(data_u8),
                                           "tile_m": query_u8.shape[-1]},
                 {"tile_q": tile_q, "tile_n": tile_n, "tile_m": tile_m})
    return _ptan.packed_tanimoto_count(_uint8(data_u8), _uint8(query_u8))


def packed_tanimoto_topk(data_u8: torch.Tensor, query_u8: torch.Tensor, *,
                         k: int, tile_q: int | None = None,
                         tile_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused packed TANIMOTO match->count->local-top-k (see
    packed_cosine_topk for the candidate-buffer contract)."""
    return _ptan.packed_tanimoto_topk(_uint8(data_u8), _uint8(query_u8), k,
                                      tile_q=tile_q, tile_n=tile_n)
