"""Packed COSINE match-count via XOR + popcount: the CUDA kernels' wrappers
and their plain PyTorch versions.

Signatures arrive bit-packed (core/packing.py): 32 signs per int32 word, data
tail bits 0 and query tail bits 1, so

    counts[q, n] = 32*W - popcount(q_words[q] XOR d_words[n])

needs no knowledge of V.  Two entry points, both kernels in
`csrc/packed_cosine.cu` (whose header says what bounds them on an H100 and
what the design does about it):

  packed_cosine_count  -- counts int32 [Q, N].  Replaces `_count_kernel` /
      `packed_cosine_count_pallas` (`src/repro/kernels/packed_cosine.py`):
      the eight xor words of a pair summed by a carry-save tree of LOP3s (4
      popcounts a pair of eight words where one a word took 8), a warp's
      data rows consecutive so that it stores 128-byte runs.
  packed_cosine_topk   -- the fused match -> count -> per-tile local top-k.
      Replaces `_topk_kernel` + `local_topk_tile`: each tile of TILE_N data
      rows contributes its kc = min(k, TILE_N) best candidates by (count desc,
      id asc), and only the candidate buffers ids / counts int32
      [Q, ceil(N / TILE_N) * kc] reach device memory -- never the [Q, N]
      count matrix.  Tiles come in ascending id order, exhausted slots are
      -1 / -1: the contract `plan._fused_candidates_topk` relies on.

TILE_N is this port's own default (2048; the TPU kernel takes 256): only the
result after `topk_from_candidates` has to equal the reference, and wider
tiles shrink the candidate buffers (113 MB per 281,250-row segment at
Q = 1024, k = 100, against 900 MB at 256).  The knob tile_n picks the tile
among the kernel's two shapes, 1024 and 2048 data rows (`common.
pick_variant`: a corpus of at most 1024 rows takes 1024 by default); the
final result is the same at either.  The fused kernel is the template
of `csrc/fused_topk.cuh`, shared with `packed_tanimoto_topk`: 64 query rows
an item over a one-byte count tile while W <= 9 (counts at or below
32W - 254 stored as 0 and recounted in the rare row that needs them), 32
rows over a two-byte tile above.

Each wrapper launches its kernel for CUDA tensors and raises when it cannot;
it takes its plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import packed_cosine_match
from repro_torch.kernels import build, common

# data rows per tile of the fused kernel: K_TN in csrc/fused_topk.cuh, which
# must agree (tests/test_torch_cosine.py reads it from the source)
TILE_N = 2048
# the block shapes each knob of the fused kernel selects: its tiles of 1024
# (K_TN_NARROW: the C entries repro_packed_cosine_topk_n1024*) or TILE_N data
# rows, and its 64 query rows an item (32 on the two-byte count tile)
TOPK_VARIANTS = {"tile_q": (64,), "tile_n": (1024, TILE_N)}
_TOPK_ENTRY = {1024: "packed_cosine_topk_n1024", TILE_N: "packed_cosine_topk"}
# the widest rows of the one-byte count tile (MAX_W_ONE_BYTE, packed_cosine.cu)
MAX_W_ONE_BYTE = 9

# The plain PyTorch version of the count kernel is the layout's reference
# semantics, `core.packing.packed_cosine_match`, bound here under the
# kernel's name so the two stand side by side.
packed_cosine_count_plain = packed_cosine_match


def packed_cosine_topk_plain(data_words: torch.Tensor, query_words: torch.Tensor,
                             k: int, tile_n: int = TILE_N) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's candidate buffers computed the plain way: the full
    count matrix cut into per-tile top-kc lists (`common.local_topk_plain`)."""
    if k < 1:
        raise ValueError(f"packed_cosine_topk: k must be >= 1, got {k}")
    return common.local_topk_plain(packed_cosine_count_plain(data_words, query_words), k, tile_n)


def _operands(name: str, data_words: torch.Tensor, query_words: torch.Tensor):
    device = data_words.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    common.check_operand(f"{name} data_words", data_words, 2, device)
    common.check_operand(f"{name} query_words", query_words, 2, device)
    n, w = data_words.shape
    if query_words.shape[1] != w:
        raise ValueError(
            f"{name}: word widths differ, data {w} vs queries {query_words.shape[1]}")
    if w == 0:
        raise ValueError(f"{name}: packed rows hold no words")
    return device, n, query_words.shape[0], w


def topk_smem(tiles: dict, w: int) -> int:
    """Shared memory a block of the fused kernel's shape `tiles` (from
    TOPK_VARIANTS) asks for at rows of w words."""
    one_byte = w <= MAX_W_ONE_BYTE
    return common.fused_topk_smem(1 if one_byte else 2, 64 if one_byte else 32,
                                  tiles["tile_n"], 32 * w + 1)


def packed_cosine_count(data_words: torch.Tensor, query_words: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from packed words int32 [N, W] and [Q, W]."""
    if data_words.device.type == "cpu" and query_words.device.type == "cpu":
        return packed_cosine_count_plain(data_words, query_words)
    device, n, q, w = _operands("packed_cosine_count", data_words, query_words)
    out = torch.empty((q, n), dtype=torch.int32, device=device)
    if q == 0 or n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.repro_packed_cosine_count(
            data_words.data_ptr(), query_words.data_ptr(), out.data_ptr(),
            n, q, w, stream)
    common.check_status("packed_cosine_count", status)
    common.note_launch("packed_cosine_count")
    return out


def packed_cosine_topk(data_words: torch.Tensor, query_words: torch.Tensor,
                       k: int, *, tile_q: int | None = None,
                       tile_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, counts) int32 [Q, ceil(N / tn) * min(k, tn)], tn the tile that
    tile_n picks (TOPK_VARIANTS): per-tile candidates in (count desc, id asc)
    order, tiles ascending, exhausted slots -1 / -1."""
    tn = common.pick_variants(TOPK_VARIANTS, {"tile_q": len(query_words),
                                              "tile_n": len(data_words)},
                              {"tile_q": tile_q, "tile_n": tile_n})["tile_n"]
    if data_words.device.type == "cpu" and query_words.device.type == "cpu":
        return packed_cosine_topk_plain(data_words, query_words, k, tn)
    if k < 1:
        raise ValueError(f"packed_cosine_topk: k must be >= 1, got {k}")
    device, n, q, w = _operands("packed_cosine_topk", data_words, query_words)
    return common.launch_fused_topk("packed_cosine_topk", data_words, query_words, device,
                                    n, q, w, k, tn, entry=_TOPK_ENTRY[tn])

