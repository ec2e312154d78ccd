"""MinHash LSH for Jaccard similarity over sets (paper section II-B1: "Jaccard
kernel for sets").

h_i(S) = min_{e in S} pi_i(e) with pi_i a random permutation (approximated by
the Murmur fmix32 bijection keyed per function).  Pr[h(S) = h(T)] = J(S, T),
which satisfies GENIE's LSH definition (Eqn 1) exactly.

The reference (`repro/core/lsh/minhash.py`) forms every permuted element at
once, [..., m, L]; at one SIFT-shaped add (281,250 rows, m = 238, 128
elements) that is 8.6e9 values.  Here the minimum is folded over the element
axis one element at a time on [..., m]: a minimum does not depend on the
order it is taken in, so the signatures are exactly the reference's.  Values
are uint32 held in int64 (core/lsh/rehash.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.lsh import rehash as _rehash
from repro_torch.device import DeviceLike, resolve_device

# the minimum of an empty set: the reference's uint32 0xFFFFFFFF, which its
# int32 cast turns into -1 and its rehash back into 0xFFFFFFFF
_EMPTY = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class MinHashParams:
    seeds: torch.Tensor         # [m] int64 per-function permutation seeds in [0, 2^32)
    rehash_seeds: torch.Tensor  # [m] int64 seeds for the bucket projection
    n_buckets: int

    @property
    def dims(self) -> tuple[int, None]:
        """(m hash functions, None): minhash acts on element ids, so its
        parameters fix no input dimension (the service takes it from the
        first add)."""
        return int(self.seeds.shape[0]), None

    def to(self, device: DeviceLike) -> "MinHashParams":
        return dataclasses.replace(self, seeds=self.seeds.to(device),
                                   rehash_seeds=self.rehash_seeds.to(device))


def make(generator: Optional[torch.Generator], m: int, n_buckets: int = 8192,
         d: Optional[int] = None, device: DeviceLike = None) -> MinHashParams:
    """`d` is accepted (and ignored) so the scheme registry's uniform
    make_params(generator, d=..., m=..., ...) call works -- minhash is
    dimension-free (permutations act on element ids, not coordinates).
    Seeds are drawn on the generator's own device and then moved to
    `device` (None: the card)."""
    device = resolve_device(device)
    gdev = generator.device if generator is not None else "cpu"
    return MinHashParams(
        seeds=_rehash.make_seeds(generator, m, device=gdev),
        rehash_seeds=_rehash.make_seeds(generator, m, device=gdev),
        n_buckets=n_buckets,
    ).to(device)


def params_from_numpy(seeds, rehash_seeds, n_buckets: int,
                      device: DeviceLike = None) -> MinHashParams:
    """MinHashParams from another implementation's seeds handed over as numpy
    arrays (seeds [m] and rehash_seeds [m], uint32), so both hash with
    identical functions; on `device` (None: the card)."""
    device = resolve_device(device)
    s = torch.from_numpy(np.asarray(seeds).astype(np.int64) & 0xFFFFFFFF)
    r = torch.from_numpy(np.asarray(rehash_seeds).astype(np.int64) & 0xFFFFFFFF)
    if s.dim() != 1 or r.shape != s.shape:
        raise ValueError(
            f"expected seeds [m] and rehash_seeds [m]; got {tuple(s.shape)}, "
            f"{tuple(r.shape)}")
    return MinHashParams(seeds=s, rehash_seeds=r, n_buckets=int(n_buckets)).to(device)


def hash_sets(params: MinHashParams, elements: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """MinHash signatures for padded element-id sets.

    elements: int   [..., L]  element ids (padded rows allowed).
    valid:    bool  [..., L]  mask of real elements.
    returns:  int32 [..., m]  signatures in [0, n_buckets).
    """
    seeds = _rehash.as_u32(params.seeds)
    mins = torch.full(tuple(elements.shape[:-1]) + (seeds.shape[0],), _EMPTY,
                      dtype=torch.int64, device=elements.device)
    for i in range(elements.shape[-1]):
        perm = _rehash.fmix32(_rehash.as_u32(elements[..., i, None]) ^ seeds)
        torch.minimum(mins, torch.where(valid[..., i, None], perm, _EMPTY), out=mins)
        del perm
    return _rehash.rehash(mins, params.rehash_seeds, params.n_buckets)


def hash_points(params: MinHashParams, x: torch.Tensor) -> torch.Tensor:
    """MinHash dense vectors via their positive-support feature set.

    A vector x is read as the set {i : x_i > 0} (binarised feature support --
    the sparse ultra-high-dimensional regime FLASH targets), then minhashed as
    `hash_sets` would with elements 0..d-1.  Gives the scheme registry the
    uniform hash_points(params, x [..., d]) -> sigs [..., m] signature.  The
    element ids are the same for every row, so each element's m permuted
    values are computed once ([d, m]) and only the masked minimum runs per
    row.
    """
    d = x.shape[-1]
    seeds = _rehash.as_u32(params.seeds)
    elems = torch.arange(d, dtype=torch.int64, device=x.device)
    perm = _rehash.fmix32(elems[:, None] ^ seeds[None, :])          # [d, m]
    mins = torch.full(tuple(x.shape[:-1]) + (seeds.shape[0],), _EMPTY,
                      dtype=torch.int64, device=x.device)
    support = x > 0
    for i in range(d):
        torch.minimum(mins, torch.where(support[..., i, None], perm[i], _EMPTY), out=mins)
    return _rehash.rehash(mins, params.rehash_seeds, params.n_buckets)


def jaccard(a_elems, a_valid, b_elems, b_valid) -> float:
    """Host-side exact Jaccard for validation."""
    sa = set(int(x) for x, v in zip(a_elems, a_valid) if v)
    sb = set(int(x) for x, v in zip(b_elems, b_valid) if v)
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / len(sa | sb)
