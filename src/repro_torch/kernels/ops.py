"""Public entries of the kernel layer: what the GENIE engines call.

The counterpart of `repro/kernels/ops.py`, with an entry for every engine's
kernel and the c-PQ histogram.  The TPU wrappers pad inputs to tile multiples
with sentinels (-1 / -2, 255 / 254 for uint8 buckets, the empty range lo = 1,
hi = 0 for RANGE queries) and slice the result back; the CUDA kernels mask
their ragged edges themselves, so no sentinel reaches them and an entry here
only brings its operands to the form the kernel takes (int32, int8 signs or
word vectors, uint8 buckets, contiguous -- the cast the reference applies,
on every call) and calls the wrapper.  `repro_torch.kernels.ref` holds the oracles.
"""
from __future__ import annotations

import torch

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


def match_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor) -> torch.Tensor:
    """EQ engine kernel: counts int32 [Q, N]."""
    return _mc.match_count(_int32(data_sigs), _int32(query_sigs))


def range_count(data_vals: torch.Tensor, q_lo: torch.Tensor,
                q_hi: torch.Tensor) -> torch.Tensor:
    """RANGE engine kernel: counts int32 [Q, N]."""
    return _rc.range_count(_int32(data_vals), _int32(q_lo), _int32(q_hi))


def minsum_count(data_cnt: torch.Tensor, query_cnt: torch.Tensor) -> torch.Tensor:
    """MINSUM engine kernel: counts int32 [Q, N]."""
    return _ms.minsum_count(_int32(data_cnt), _int32(query_cnt))


def ip_count(data_bin: torch.Tensor, query_bin: torch.Tensor) -> torch.Tensor:
    """IP engine kernel: exact int32 counts [Q, N] from binary word vectors
    (any dtype; the kernel takes int8, so other dtypes are cast here on every
    call, as the reference's wrapper casts to bf16)."""
    return _ip.ip_count(_int8(data_bin), _int8(query_bin))


def cpq_hist(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """c-PQ Gate histogram: int32 [Q, max_count + 1]."""
    return _cpq_hist.cpq_hist(_int32(counts), max_count)


def tanimoto_count(data_sigs: torch.Tensor, query_sigs: torch.Tensor) -> torch.Tensor:
    """TANIMOTO engine kernel: minhash collision counts int32 [Q, N]."""
    return _tc.tanimoto_count(_int32(data_sigs), _int32(query_sigs))


def cosine_count(data_sgn: torch.Tensor, query_sgn: torch.Tensor) -> torch.Tensor:
    """COSINE engine kernel: sign-agreement counts int32 [Q, N] from sign
    vectors in {-1, 0, +1} (zero rows floor to V // 2)."""
    return _cos.cosine_count(_int8(data_sgn), _int8(query_sgn))


def packed_cosine_count(data_words: torch.Tensor, query_words: torch.Tensor) -> torch.Tensor:
    """Packed COSINE kernel: XOR+popcount agreement counts int32 [Q, N] from
    the word matrices of core/packing.py (query tail bits 1, data tail 0)."""
    return _pcos.packed_cosine_count(_int32(data_words), _int32(query_words))


def packed_cosine_topk(data_words: torch.Tensor, query_words: torch.Tensor, *,
                       k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused packed COSINE match->count->local-top-k: (ids, counts) int32
    [Q, n_tiles * min(k, TILE_N)] candidate buffers in per-tile (count desc,
    id asc) order; ids are object ids, empty slots are -1 / -1."""
    return _pcos.packed_cosine_topk(_int32(data_words), _int32(query_words), k)


def packed_tanimoto_count(data_u8: torch.Tensor, query_u8: torch.Tensor) -> torch.Tensor:
    """Packed TANIMOTO kernel: byte-lane collision counts int32 [Q, N]."""
    return _ptan.packed_tanimoto_count(_uint8(data_u8), _uint8(query_u8))


def packed_tanimoto_topk(data_u8: torch.Tensor, query_u8: torch.Tensor, *,
                         k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused packed TANIMOTO match->count->local-top-k (see
    packed_cosine_topk for the candidate-buffer contract)."""
    return _ptan.packed_tanimoto_topk(_uint8(data_u8), _uint8(query_u8), k)
