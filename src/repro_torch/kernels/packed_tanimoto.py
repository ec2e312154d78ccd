"""Packed TANIMOTO match-count on uint8 minhash buckets: the CUDA kernels'
wrappers and their plain PyTorch versions.

Bucket ids arrive one byte each (core/packing.py `pack_buckets`: ids in
[0, 253]), and the match is the equality compare on byte lanes:

    counts[q, n] = sum_i (data_u8[n, i] == query_u8[q, i])       int32 [Q, N]

bit for bit the counts of the WIDE kernel (kernels/tanimoto_count.py).  Two
entry points, both kernels in `csrc/packed_tanimoto.cu` (whose header says
what bounds them on an H100 and what the design does about it):

  packed_tanimoto_count  -- counts int32 [Q, N].  Replaces `_count_kernel` /
      `packed_tanimoto_count_pallas` (`src/repro/kernels/packed_tanimoto.py`).
  packed_tanimoto_topk   -- the fused match -> count -> per-tile local top-k.
      Replaces `_topk_kernel`, which reuses `local_topk_tile` of the packed
      COSINE kernel; here the fused kernel is `csrc/fused_topk.cuh`, shared
      with `packed_cosine_topk`, and so is the candidate-buffer contract: each
      tile of tn data rows (tile_n picks 1024 or TILE_N, as for
      packed_cosine_topk) contributes its kc = min(k, tn) best candidates by
      (count desc, id asc), ids / counts int32 [Q, ceil(N / tn) * kc], tiles
      ascending, exhausted slots -1 / -1.  The kernel
      counts 64 query rows at a time against a tile (32 above m = 254) into
      a one-byte (two-byte) count tile in shared memory, so the signature
      width it takes is at most TOPK_MAX_M.  Its bound is the word-pair
      work: 1.7e10 byte-lane compares of four at Q = 1024, N = 281,250, m =
      238, at the popcount rate of an H100.

Each wrapper launches its kernel for CUDA tensors and raises when it cannot;
it takes its plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import packed_tanimoto_match
from repro_torch.kernels import build, common

# data rows per tile of the fused kernel: K_TN in csrc/fused_topk.cuh, which
# must agree (tests/test_torch_tanimoto.py reads it from the source)
TILE_N = 2048
# the block shapes each knob of the fused kernel selects: its tiles of 1024
# (K_TN_NARROW: the C entries repro_packed_tanimoto_topk_n1024*) or TILE_N
# data rows, and its 64 query rows an item (32 on the two-byte count tile)
TOPK_VARIANTS = {"tile_q": (64,), "tile_n": (1024, TILE_N)}
_TOPK_ENTRY = {1024: "packed_tanimoto_topk_n1024", TILE_N: "packed_tanimoto_topk"}
# the widest rows of the one-byte count tile (CountU8::MAX_M, packed_tanimoto.cu)
MAX_M_ONE_BYTE = 254
# the widest rows the fused kernel takes: its counts are at most two bytes
# (CountU16::MAX_M in csrc/packed_tanimoto.cu)
TOPK_MAX_M = 65534

# The plain PyTorch version of the count kernel is the layout's reference
# semantics, `core.packing.packed_tanimoto_match`, bound here under the
# kernel's name so the two stand side by side.
packed_tanimoto_count_plain = packed_tanimoto_match


def packed_tanimoto_topk_plain(data_u8: torch.Tensor, query_u8: torch.Tensor,
                               k: int, tile_n: int = TILE_N) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's candidate buffers computed the plain way: the full
    count matrix cut into per-tile top-kc lists (`common.local_topk_plain`)."""
    if k < 1:
        raise ValueError(f"packed_tanimoto_topk: k must be >= 1, got {k}")
    return common.local_topk_plain(packed_tanimoto_count_plain(data_u8, query_u8), k, tile_n)


def _operands(name: str, data_u8: torch.Tensor, query_u8: torch.Tensor):
    device = data_u8.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    common.check_operand(f"{name} data_u8", data_u8, 2, device, torch.uint8)
    common.check_operand(f"{name} query_u8", query_u8, 2, device, torch.uint8)
    n, m = data_u8.shape
    if query_u8.shape[1] != m:
        raise ValueError(
            f"{name}: signature widths differ, data {m} vs queries {query_u8.shape[1]}")
    if m == 0:
        raise ValueError(f"{name}: packed rows hold no signature slots")
    return device, n, query_u8.shape[0], m


def topk_smem(tiles: dict, m: int) -> int:
    """Shared memory a block of the fused kernel's shape `tiles` (from
    TOPK_VARIANTS) asks for at rows of m bytes."""
    one_byte = m <= MAX_M_ONE_BYTE
    return common.fused_topk_smem(1 if one_byte else 2, 64 if one_byte else 32,
                                  tiles["tile_n"], m + 1)


def packed_tanimoto_count(data_u8: torch.Tensor, query_u8: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, N] from uint8 buckets [N, m] and [Q, m]."""
    if data_u8.device.type == "cpu" and query_u8.device.type == "cpu":
        return packed_tanimoto_count_plain(data_u8, query_u8)
    device, n, q, m = _operands("packed_tanimoto_count", data_u8, query_u8)
    out = torch.empty((q, n), dtype=torch.int32, device=device)
    if q == 0 or n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = lib.repro_packed_tanimoto_count(
            data_u8.data_ptr(), query_u8.data_ptr(), out.data_ptr(), n, q, m, stream)
    common.check_status("packed_tanimoto_count", status)
    common.note_launch("packed_tanimoto_count")
    return out


def packed_tanimoto_topk(data_u8: torch.Tensor, query_u8: torch.Tensor,
                         k: int, *, tile_q: int | None = None,
                         tile_n: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, counts) int32 [Q, ceil(N / tn) * min(k, tn)], tn the tile that
    tile_n picks (TOPK_VARIANTS): per-tile candidates in (count desc, id asc)
    order, tiles ascending, exhausted slots -1 / -1."""
    tn = common.pick_variants(TOPK_VARIANTS, {"tile_q": len(query_u8), "tile_n": len(data_u8)},
                              {"tile_q": tile_q, "tile_n": tile_n})["tile_n"]
    if data_u8.device.type == "cpu" and query_u8.device.type == "cpu":
        return packed_tanimoto_topk_plain(data_u8, query_u8, k, tn)
    if k < 1:
        raise ValueError(f"packed_tanimoto_topk: k must be >= 1, got {k}")
    device, n, q, m = _operands("packed_tanimoto_topk", data_u8, query_u8)
    if m > TOPK_MAX_M:
        raise ValueError(f"packed_tanimoto_topk: m = {m} exceeds the kernel's {TOPK_MAX_M}")
    return common.launch_fused_topk("packed_tanimoto_topk", data_u8, query_u8, device,
                                    n, q, m, k, tn, entry=_TOPK_ENTRY[tn])
