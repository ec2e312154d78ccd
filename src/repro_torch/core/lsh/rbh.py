"""Random Binning Hashing (RBH) for the Laplacian kernel (paper section IV-A3).

Rahimi & Recht random features: for a separable kernel k(p,q) = prod_d k1(|p_d - q_d|)
whose per-dim kernel k1 has p(g) = g * k1''(g) a valid density on g >= 0, impose a
randomly shifted grid with pitch g ~ p(g) and shift u ~ U[0, g] per dimension:

    h(p) = [ floor((p_1 - u_1)/g_1), ..., floor((p_d - u_d)/g_d) ]      (paper Eqn 2)

Then Pr[h(p) = h(q)] = k(p, q).  For the Laplacian kernel
k(p,q) = exp(-||p-q||_1 / sigma), the pitch density per dimension is
p(g) = (g / sigma^2) exp(-g / sigma), i.e. Gamma(shape=2, scale=sigma).

The signature is a d-dimensional integer vector -- a huge space -- so GENIE
re-hashes it into [0, D) with r(.) (rehash.rehash_vector).  The reference
forms every grid cell at once, [..., m, d]; at OCR's d = 1156 one 218,750-row
add is 6.0e10 cells.  `hash_points` here computes each coordinate's cell on
[..., m] inside the fold over d, in the reference's order of operations
(float32 subtract, divide, floor) and folding order, so the signatures are
the reference's without the [..., m, d] tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.lsh import rehash as _rehash
from repro_torch.device import DeviceLike, resolve_device, tensor_from


@dataclasses.dataclass(frozen=True)
class RBHParams:
    g: torch.Tensor            # [m, d] float32 grid pitches ~ Gamma(2, sigma)
    u: torch.Tensor            # [m, d] float32 shifts ~ U[0, g]
    dim_seeds: torch.Tensor    # [m, d] int64 per-coordinate combine seeds in [0, 2^32)
    sigma: float
    n_buckets: int

    @property
    def dims(self) -> tuple[int, int]:
        """(m hash functions, d input dimensions)."""
        m, d = self.g.shape
        return int(m), int(d)

    def to(self, device: DeviceLike) -> "RBHParams":
        return dataclasses.replace(self, g=self.g.to(device), u=self.u.to(device),
                                   dim_seeds=self.dim_seeds.to(device))


def make(generator: Optional[torch.Generator], d: int, m: int, sigma: float,
         n_buckets: int = 8192, device: DeviceLike = None) -> RBHParams:
    """m random grids over d-dim points, drawn from `generator` on the
    generator's own device and then moved to `device` (None: the card)."""
    device = resolve_device(device)
    gdev = generator.device if generator is not None else "cpu"
    # Gamma(shape=2, scale=sigma): the sum of two Exp(scale=sigma) draws
    e1 = torch.empty((m, d), dtype=torch.float32, device=gdev).exponential_(generator=generator)
    e2 = torch.empty((m, d), dtype=torch.float32, device=gdev).exponential_(generator=generator)
    g = sigma * (e1 + e2)
    u = torch.rand((m, d), generator=generator, dtype=torch.float32, device=gdev) * g
    dim_seeds = torch.randint(0, 2**31 - 1, (m, d), generator=generator,
                              dtype=torch.int64, device=gdev)
    return RBHParams(g=g, u=u, dim_seeds=dim_seeds, sigma=float(sigma),
                     n_buckets=n_buckets).to(device)


def params_from_numpy(g, u, dim_seeds, sigma: float, n_buckets: int,
                      device: DeviceLike = None) -> RBHParams:
    """RBHParams from another implementation's parameters handed over as
    numpy arrays (g and u [m, d] float32, dim_seeds [m, d] uint32), so both
    hash with identical functions; on `device` (None: the card)."""
    device = resolve_device(device)
    g = tensor_from(np.asarray(g, dtype=np.float32))
    u = tensor_from(np.asarray(u, dtype=np.float32))
    seeds = torch.from_numpy(np.asarray(dim_seeds).astype(np.int64) & 0xFFFFFFFF)
    if g.dim() != 2 or u.shape != g.shape or seeds.shape != g.shape:
        raise ValueError(
            f"expected g, u and dim_seeds of one shape [m, d]; got {tuple(g.shape)}, "
            f"{tuple(u.shape)}, {tuple(seeds.shape)}")
    return RBHParams(g=g, u=u, dim_seeds=seeds, sigma=float(sigma),
                     n_buckets=int(n_buckets)).to(device)


def raw_hash(params: RBHParams, x: torch.Tensor) -> torch.Tensor:
    """Grid coordinates int32 [..., m, d] (the whole cell tensor: small inputs
    only; `hash_points` never forms it)."""
    x = x.to(torch.float32)[..., None, :]
    return torch.floor((x - params.u) / params.g).to(torch.int32)


def hash_points(params: RBHParams, x: torch.Tensor) -> torch.Tensor:
    """Signatures int32 [..., m] in [0, n_buckets): each function's vector of
    d grid cells folded by rehash.hash_combine in coordinate order, as
    rehash.rehash_vector folds it, then finalised and bucketed."""
    x = x.to(torch.float32)
    m, d = params.dims
    seeds = _rehash.as_u32(params.dim_seeds)
    acc = torch.zeros(tuple(x.shape[:-1]) + (m,), dtype=torch.int64, device=x.device)
    for i in range(d):
        # coordinate i's grid cell under every function, int32 [..., m]
        cell = torch.floor((x[..., i, None] - params.u[:, i]) / params.g[:, i]).to(torch.int32)
        acc = _rehash.hash_combine(acc, _rehash.as_u32(cell) ^ seeds[:, i])
    return (_rehash.fmix32(acc) % int(params.n_buckets)).to(torch.int32)


def kernel(x: torch.Tensor, y: torch.Tensor, sigma: float) -> torch.Tensor:
    """Laplacian kernel k(p,q) = exp(-||p-q||_1 / sigma) == expected collision prob."""
    return torch.exp(-torch.sum(torch.abs(x - y), dim=-1) / sigma)


def median_heuristic_sigma(points: torch.Tensor, generator: Optional[torch.Generator],
                           n_pairs: int = 2048) -> float:
    """Kernel-width heuristic used in the paper (Jaakkola et al.): mean pairwise
    l1 distance over a random sample of pairs drawn from `generator`."""
    n = points.shape[0]
    gdev = generator.device if generator is not None else "cpu"
    i = torch.randint(0, n, (n_pairs,), generator=generator, device=gdev).to(points.device)
    j = torch.randint(0, n, (n_pairs,), generator=generator, device=gdev).to(points.device)
    d = torch.sum(torch.abs(points[i] - points[j]), dim=-1)
    return float(torch.mean(d))
