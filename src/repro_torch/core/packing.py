"""Bit/byte-packed signature formats (FLASH's core trick, Wang et al.
1709.01190; compact codes as the billion-scale prerequisite, Johnson et al.
1702.08734).

COSINE / sign vectors -> int32 bitfields.  The WIDE COSINE layout stores one
+-1 *sign* (1 bit of signal) per int8 element.  The PACKED layout stores 32
signs per int32 word:

    word w, bit b of a packed row holds (sign[32*w + b] > 0)

so rows narrow from V bytes to ceil(V/32)*4 bytes.  The sign-agreement count
is recovered by XOR + popcount:

    agreements = 32*W - popcount(q_words XOR d_words)

with the *data* tail bits (past V in the last word) packed as 0 and the
*query* tail bits packed as 1, so every tail bit is a guaranteed disagreement
and the identity needs no knowledge of V -- the packed match keeps the
canonical ``fn(data, queries) -> counts`` signature.  Counts are bit for bit
those of the WIDE reference.

Words are stored as int32, bit-identical to the reference's
(`repro/core/packing.py`).  PyTorch has no uint32 arithmetic to speak of, so
every word is assembled and taken apart as the int64 value of its 32 bits
(masked with 0xFFFFFFFF) and only then mapped into int32; no right shift ever
acts on a signed int32.

TANIMOTO / minhash sketches -> uint8 bucket ids.  Bucket ids narrow from 4
bytes to 1 when the rehash domain fits a byte; the match is the same equality
compare on byte lanes.  Values 254/255 are the reference's query/data pad
sentinels (the CUDA kernels stage them past m in shared memory), so packing
requires bucket ids <= PACKED_BUCKET_MAX.
"""
from __future__ import annotations

import torch

from repro_torch.core import match as _match

WORD_BITS = 32
_MASK32 = 0xFFFFFFFF
# uint8 sentinels of the packed-TANIMOTO kernels: 255 fills data slots past m,
# 254 query slots past m (distinct, so pads never collide)
PACKED_BUCKET_PAD_DATA = 255
PACKED_BUCKET_PAD_QUERY = 254
PACKED_BUCKET_MAX = 253


def packed_words(v: int) -> int:
    """Words per packed sign row for a logical dimensionality of v."""
    return -(-int(v) // WORD_BITS)


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _pack_bits(bits: torch.Tensor, tail_bit: bool) -> torch.Tensor:
    """bool [N, V] -> int32 words [N, ceil(V/32)] (little-endian bit order),
    tail slots past V filled with `tail_bit`."""
    n, v = bits.shape
    w = packed_words(v)
    pad = w * WORD_BITS - v
    if pad:
        fill = torch.full((n, pad), bool(tail_bit), dtype=torch.bool, device=bits.device)
        bits = torch.cat([bits, fill], dim=1)
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << torch.arange(
        WORD_BITS, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(n, w, WORD_BITS).to(torch.int64) * weights).sum(dim=-1)
    return _to_int32(words).contiguous()


def pack_signs_data(sgn: torch.Tensor) -> torch.Tensor:
    """Sign-quantized data {-1,+1} [N, V] -> packed int32 words [N, W];
    tail bits 0 (they pair with query tail bits 1 -> always a disagreement)."""
    return _pack_bits(sgn > 0, tail_bit=False)


def pack_signs_queries(sgn: torch.Tensor) -> torch.Tensor:
    """Sign-quantized queries {-1,+1} [Q, V] -> packed int32 words [Q, W];
    tail bits 1 (see pack_signs_data)."""
    return _pack_bits(sgn > 0, tail_bit=True)


def unpack_signs(words: torch.Tensor, v: int) -> torch.Tensor:
    """Packed int32 words [N, W] -> signs {-1,+1} int8 [N, v] (testing aid)."""
    u = words.to(torch.int64) & _MASK32
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (u[..., None] >> shifts) & 1                 # [N, W, 32]
    flat = bits.reshape(words.shape[0], -1)[:, :v]
    return torch.where(flat == 1, 1, -1).to(torch.int8)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value, x an int64 tensor in [0, 2^32) (SWAR:
    pair, nibble and byte sums; the byte sums add up in the top byte of the
    product).  Updates x in place."""
    x -= (x >> 1) & 0x55555555
    x = (x & 0x33333333).add_((x >> 2) & 0x33333333)
    x.add_(x >> 4).bitwise_and_(0x0F0F0F0F)
    return (x.mul_(0x01010101).bitwise_and_(_MASK32)) >> 24


def packed_cosine_match(data_words: torch.Tensor, query_words: torch.Tensor,
                        chunk: int = 2) -> torch.Tensor:
    """counts[q, n] = 32*W - popcount(q_words ^ d_words) -> int32 [Q, N]: the
    plain PyTorch reference of the packed COSINE layout (the CUDA kernels in
    kernels/packed_cosine.py are the hot path).  Exact -- not an estimate --
    versus match_cosine on the unpacked signs.  A loop over `chunk` words at a
    time keeps the live temps at [Q, N, chunk] int64."""
    d = data_words.to(torch.int64) & _MASK32
    s = query_words.to(torch.int64) & _MASK32
    q, w = s.shape
    n = d.shape[0]
    disagree = torch.zeros((q, n), dtype=torch.int32, device=d.device)
    for start in range(0, w, chunk):
        x = torch.bitwise_xor(s[:, None, start:start + chunk], d[None, :, start:start + chunk])
        disagree += _popcount32(x).sum(dim=-1, dtype=torch.int32)
        del x
    return WORD_BITS * w - disagree


def pack_buckets(sigs: torch.Tensor) -> torch.Tensor:
    """Minhash bucket ids int [N, m] -> uint8 [N, m].

    Raises ValueError when a bucket id falls outside [0, PACKED_BUCKET_MAX]
    (254/255 are the kernel pad sentinels) -- the PACKED layout applies to
    byte-sized rehash domains; keep WIDE (or rehash to <= 254 buckets) above
    that.  Min and max come from one aminmax: one device sync per call.
    """
    lo, hi = (int(v) for v in torch.aminmax(sigs))
    if lo < 0 or hi > PACKED_BUCKET_MAX:
        raise ValueError(
            f"PACKED TANIMOTO signatures must lie in [0, {PACKED_BUCKET_MAX}] "
            f"(254/255 are pad sentinels); got values in [{lo}, {hi}] -- "
            f"use SignatureLayout.WIDE or rehash to <= {PACKED_BUCKET_MAX + 1} "
            f"buckets"
        )
    return sigs.to(torch.uint8).contiguous()


def packed_tanimoto_match(data_u8: torch.Tensor, query_u8: torch.Tensor) -> torch.Tensor:
    """Byte-lane collision count -> int32 [Q, N]: the plain PyTorch reference
    of the packed TANIMOTO layout (identical counts to match_tanimoto on the
    int32 ids; the CUDA kernels in kernels/packed_tanimoto.py are the hot
    path).  Equal bytes are equal int32 ids, so the compare runs on the bytes
    as they are stored."""
    return _match.match_eq(data_u8, query_u8)


def packed_bytes_cosine(wide: torch.Tensor) -> int:
    """Packed footprint of a WIDE sign matrix [N, V]: ceil(V/32) words/row."""
    return int(wide.shape[0]) * packed_words(int(wide.shape[1])) * 4


def packed_bytes_tanimoto(wide: torch.Tensor) -> int:
    """Packed footprint of a WIDE sketch matrix [N, m]: one byte per slot."""
    return int(wide.shape[0]) * int(wide.shape[1])
