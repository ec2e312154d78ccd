"""Plain PyTorch oracles for every CUDA kernel (the reference semantics).

The engine references live in repro_torch.core.match; they are re-exported
here so tests can sweep (kernel vs ref) from one import site.
"""
from __future__ import annotations

import torch

from repro_torch.core.match import (  # noqa: F401
    match_cosine,
    match_eq,
    match_ip,
    match_minsum,
    match_range,
    match_tanimoto,
    tanimoto_exact,
)
from repro_torch.core.packing import packed_cosine_match, packed_tanimoto_match  # noqa: F401


def cpq_hist(counts: torch.Tensor, nbins: int) -> torch.Tensor:
    """hist[q, t] = #{n : counts[q, n] == t} for t in [0, nbins)."""
    c = counts.to(torch.int32)
    bins = torch.arange(nbins, dtype=torch.int32, device=c.device)
    return (c[..., None] == bins).sum(dim=1, dtype=torch.int32)
