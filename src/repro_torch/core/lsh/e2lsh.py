"""E2LSH: p-stable locality sensitive hashing (paper Eqn 10/11, Datar et al.).

h(q) = floor((a . q + b) / w) with `a` drawn from a p-stable distribution
(Gaussian for l2, Cauchy for l1) and b ~ U[0, w).

The collision probability (paper Eqn 11)

    psi_p(delta) = Pr[h(p) = h(q)]
                 = int_0^w (1/delta) phi_p(t/delta) (1 - t/w) dt

is strictly monotonically decreasing in delta = ||p - q||_p, so it defines the
similarity measure sim_lp (Eqn 12) under which GENIE performs tau-ANN search.
Closed forms are implemented below for l1 and l2.

The projection is a plain float32 matrix product and stays `torch.matmul`;
it runs in full float32 (the serving layer sets
`torch.backends.cuda.matmul.allow_tf32 = False`): TF32 would move points
across bucket boundaries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.lsh import rehash as _rehash
from repro_torch.device import DeviceLike, resolve_device, tensor_from


@dataclasses.dataclass(frozen=True)
class E2LSHParams:
    a: torch.Tensor         # [m, d] float32 p-stable projection vectors
    b: torch.Tensor         # [m]    float32 uniform shifts in [0, w)
    seeds: torch.Tensor     # [m]    int64 rehash seeds in [0, 2^32)
    w: float
    p: int
    n_buckets: int

    @property
    def dims(self) -> tuple[int, int]:
        """(m hash functions, d input dimensions)."""
        m, d = self.a.shape
        return int(m), int(d)

    def to(self, device: DeviceLike) -> "E2LSHParams":
        return dataclasses.replace(self, a=self.a.to(device), b=self.b.to(device),
                                   seeds=self.seeds.to(device))


def make(generator: Optional[torch.Generator], d: int, m: int, w: float, p: int = 2,
         n_buckets: int = 8192, device: DeviceLike = None) -> E2LSHParams:
    """Create m independent p-stable LSH functions for d-dim points.

    Parameters are drawn from `generator` on the generator's own device and
    then moved to `device` (None: the card), so one seed gives one set of
    functions wherever they run.
    """
    device = resolve_device(device)
    gdev = generator.device if generator is not None else "cpu"
    if p == 2:
        a = torch.randn((m, d), generator=generator, dtype=torch.float32, device=gdev)
    elif p == 1:
        a = torch.empty((m, d), dtype=torch.float32, device=gdev).cauchy_(generator=generator)
    else:
        raise ValueError(f"p-stable sampling implemented for p in (1, 2), got {p}")
    b = torch.rand((m,), generator=generator, dtype=torch.float32, device=gdev) * w
    seeds = _rehash.make_seeds(generator, m, device=gdev)
    return E2LSHParams(a=a, b=b, seeds=seeds, w=w, p=p, n_buckets=n_buckets).to(device)


def params_from_numpy(a, b, seeds, w: float, p: int, n_buckets: int,
                      device: DeviceLike = None) -> E2LSHParams:
    """E2LSHParams from another implementation's parameters handed over as
    numpy arrays (a [m, d] float32, b [m] float32, seeds [m] uint32), so both
    hash with identical functions; on `device` (None: the card)."""
    device = resolve_device(device)
    a = tensor_from(np.asarray(a, dtype=np.float32))
    b = tensor_from(np.asarray(b, dtype=np.float32))
    seeds = torch.from_numpy(np.asarray(seeds).astype(np.int64) & 0xFFFFFFFF)
    if a.dim() != 2 or b.shape != (a.shape[0],) or seeds.shape != (a.shape[0],):
        raise ValueError(
            f"expected a [m, d], b [m], seeds [m]; got {tuple(a.shape)}, "
            f"{tuple(b.shape)}, {tuple(seeds.shape)}"
        )
    return E2LSHParams(a=a, b=b, seeds=seeds, w=float(w), p=int(p),
                       n_buckets=int(n_buckets)).to(device)


def raw_hash(params: E2LSHParams, x: torch.Tensor) -> torch.Tensor:
    """floor((a.x + b)/w) -> int32 [..., m] (pre-rehash bucket coordinates)."""
    proj = torch.matmul(x.to(torch.float32), params.a.T)
    return torch.floor((proj + params.b) / params.w).to(torch.int32)


def hash_points(params: E2LSHParams, x: torch.Tensor) -> torch.Tensor:
    """Full GENIE transform: signatures int32 [..., m] in [0, n_buckets)."""
    return _rehash.rehash(raw_hash(params, x), params.seeds, params.n_buckets)


# ---------------------------------------------------------------------------
# Collision probability psi_p (paper Eqn 11) -- closed forms.
# ---------------------------------------------------------------------------

def collision_prob_l2(dist, w: float) -> torch.Tensor:
    """psi_2(delta) for Gaussian projections (Datar et al. Eqn in section 3.2)."""
    dist = torch.clamp(torch.as_tensor(dist, dtype=torch.float32), min=1e-12)
    r = w / dist
    # 1 - 2*Phi(-r) - (2/(sqrt(2 pi) r)) * (1 - exp(-r^2/2))
    phi_neg = 0.5 * (1.0 + torch.special.erf(-r / math.sqrt(2.0)))
    return 1.0 - 2.0 * phi_neg - (2.0 / (math.sqrt(2.0 * math.pi) * r)) * (
        1.0 - torch.exp(-(r**2) / 2.0)
    )


def collision_prob_l1(dist, w: float) -> torch.Tensor:
    """psi_1(delta) for Cauchy projections."""
    dist = torch.clamp(torch.as_tensor(dist, dtype=torch.float32), min=1e-12)
    r = w / dist
    return (2.0 * torch.atan(r) / math.pi) - (1.0 / (math.pi * r)) * torch.log1p(r**2)


def collision_prob(dist, w: float, p: int) -> torch.Tensor:
    if p == 2:
        return collision_prob_l2(dist, w)
    if p == 1:
        return collision_prob_l1(dist, w)
    raise ValueError(f"unsupported p={p}")


def similarity(params: E2LSHParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sim_lp(p, q) = psi_p(||p-q||_p)  (paper Eqn 12)."""
    if params.p == 2:
        d = torch.linalg.norm(x - y, dim=-1)
    else:
        d = torch.sum(torch.abs(x - y), dim=-1)
    return collision_prob(d, params.w, params.p)
