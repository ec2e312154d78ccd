"""Re-hashing mechanism r(.) of GENIE (paper section IV-A2, Fig 7).

LSH signatures can live in a huge (even unbounded) space.  GENIE re-hashes
each signature into a small domain [0, D) with a random projection function
r(.).  The paper uses MurmurHash3; this is the Murmur3 32-bit finalizer
(fmix32) plus seed mixing, so the whole transform runs on the device and is
deterministic across hosts.

The arithmetic is uint32 with wraparound.  PyTorch's uint32 support is thin,
so values are carried in int64 tensors holding numbers in [0, 2^32): every
multiply is reduced back with `& 0xFFFFFFFF` before the next right shift, and
the multiply itself is split in two 16-bit halves so that no intermediate
leaves the int64 range.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret an integer tensor as uint32 values, held in int64 (a
    negative int32 becomes its two's-complement value, as a C cast would)."""
    return x.to(torch.int64) & _MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c, without
    overflowing int64: x*c_lo < 2^48, and only the low 16 bits of x*c_hi
    survive the shift by 16."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer: a bijective avalanche mix on uint32
    (int64 tensor of values in [0, 2^32) in and out)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    x = x ^ (x >> 16)
    return x


def hash_combine(acc: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Combine a hash accumulator with a new value (boost-style)."""
    acc = as_u32(acc)
    value = fmix32(value)
    mixed = (value + _GOLDEN + ((acc << 6) & _MASK) + (acc >> 2)) & _MASK
    return acc ^ mixed


def rehash(signature: torch.Tensor, seed: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """r_i(h_i(p)): project integer signatures into [0, n_buckets).

    signature: int tensor [..., m]  -- one signature per hash function.
    seed:      int64 [m] in [0, 2^32) -- independent seed per function (makes
                                       the m projections r_1..r_m independent).
    returns int32 [..., m] in [0, n_buckets).
    """
    mixed = fmix32(as_u32(signature) ^ as_u32(seed))
    return (mixed % int(n_buckets)).to(torch.int32)


def rehash_vector(signature_vec: torch.Tensor, seeds: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Re-hash a *vector-valued* signature (e.g. a per-dimension grid cell
    vector) into a single bucket id in [0, n_buckets).

    signature_vec: int [..., d]   -- d-dimensional signature of ONE hash function.
    seeds:         int64 [d]      -- per-coordinate seeds in [0, 2^32).
    returns int32 [...] in [0, n_buckets).
    """
    acc = torch.zeros(signature_vec.shape[:-1], dtype=torch.int64,
                      device=signature_vec.device)
    seeds = as_u32(seeds)
    for i in range(signature_vec.shape[-1]):  # order-sensitive fold over d
        acc = hash_combine(acc, as_u32(signature_vec[..., i]) ^ seeds[i])
    return (fmix32(acc) % int(n_buckets)).to(torch.int32)


def make_seeds(generator: Optional[torch.Generator], m: int,
               device: DeviceLike = None) -> torch.Tensor:
    """Draw m independent seeds in [0, 2^31 - 1) from a torch.Generator, on
    `device` (None: the card)."""
    device = resolve_device(device)
    seeds = torch.randint(0, 2**31 - 1, (m,), generator=generator, dtype=torch.int64,
                          device=generator.device if generator is not None else "cpu")
    return seeds.to(device)
