"""SimHash (signed random projection) LSH for angular / cosine similarity.

Charikar (paper ref [5]): h_v(p) = sign(v . p) with v ~ N(0, I) satisfies

    Pr[h(p) = h(q)] = 1 - theta(p, q) / pi

which is a valid GENIE LSH family (Eqn 1) under the angular similarity
sim(p,q) = 1 - theta/pi.  Signatures are single bits, so the match-count
domain is exactly m and no re-hashing is needed.

The projection is a plain float32 matrix product and stays `torch.matmul`;
it runs in full float32 (the serving layer sets
`torch.backends.cuda.matmul.allow_tf32 = False`): TF32 would flip the sign of
projections near 0.  A projection of exactly 0 (or -0.0) hashes to 1, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, tensor_from


@dataclasses.dataclass(frozen=True)
class SimHashParams:
    v: torch.Tensor  # [m, d] float32 projection vectors

    @property
    def dims(self) -> tuple[int, int]:
        """(m hash functions, d input dimensions)."""
        m, d = self.v.shape
        return int(m), int(d)

    def to(self, device: DeviceLike) -> "SimHashParams":
        return SimHashParams(v=self.v.to(device))


def make(generator: Optional[torch.Generator], d: int, m: int,
         device: DeviceLike = None) -> SimHashParams:
    """m Gaussian projection vectors for d-dim points, drawn from `generator`
    on the generator's own device and then moved to `device` (None: the
    card)."""
    device = resolve_device(device)
    gdev = generator.device if generator is not None else "cpu"
    v = torch.randn((m, d), generator=generator, dtype=torch.float32, device=gdev)
    return SimHashParams(v=v).to(device)


def params_from_numpy(v, device: DeviceLike = None) -> SimHashParams:
    """SimHashParams from another implementation's projection matrix handed
    over as a numpy array (v [m, d] float32), so both hash with identical
    functions; on `device` (None: the card)."""
    device = resolve_device(device)
    v = tensor_from(np.asarray(v, dtype=np.float32))
    if v.dim() != 2:
        raise ValueError(f"expected v [m, d], got shape {tuple(v.shape)}")
    return SimHashParams(v=v).to(device)


def hash_points(params: SimHashParams, x: torch.Tensor) -> torch.Tensor:
    """Sign bits int32 [..., m] in {0, 1}: (x . v >= 0)."""
    proj = torch.matmul(x.to(torch.float32), params.v.T)
    return (proj >= 0).to(torch.int32)


def mle_cosine(count, m: int):
    """Cosine estimate from a sign-agreement count (the COSINE engine's MLE).

    c agreements out of m bits give Pr[agree] = 1 - theta/pi (Charikar), so
    theta_hat = pi * (1 - c/m) and cos_hat = cos(theta_hat).  Host-side numpy,
    like tau_ann.mle_similarity (Eqn 7).
    """
    frac = np.clip(np.asarray(count, dtype=np.float64) / float(m), 0.0, 1.0)
    return np.cos(math.pi * (1.0 - frac))


def similarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Angular similarity 1 - theta/pi."""
    xn = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
    yn = y / torch.clamp(torch.linalg.norm(y, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp(torch.sum(xn * yn, dim=-1), -1.0, 1.0)
    return 1.0 - torch.arccos(cos) / math.pi
