"""Unified top-k selection: one pipeline for every search path.

`select_topk` dispatches on `SearchParams.method` (c-PQ gate / SPQ bucket
narrowing / full sort).  `SearchParams.use_kernel` chooses the kernel path:
there c-PQ's histogram is the CUDA kernel of kernels/cpq_hist, and the
candidates of c-PQ and SPQ are compacted by the CUDA kernel of
kernels/cpq_compact (core/cpq.py, core/spq.py).

Its only caller is the unified executor (core/plan.py) -- every layout
selects through the same per-part step there, which is what makes the
selection strategy a *parameter* of a search rather than a property of the
call site.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core import cpq as _cpq
from repro_torch.core import spq as _spq
from repro_torch.core.types import SearchParams, TopKMethod, TopKResult


def select_topk(counts: torch.Tensor, params: SearchParams) -> TopKResult:
    """Exact top-k by match count.  counts: int [Q, N] -> TopKResult [Q, k]."""
    if params.method == TopKMethod.CPQ:
        return _cpq.cpq_select(counts, params)
    if params.method == TopKMethod.SPQ:
        with trace.span("spq_select"):
            return _spq.spq_select(counts, params)
    if params.method == TopKMethod.SORT:
        with trace.span("sort_select"):
            return _cpq.sort_select(counts, params)
    raise ValueError(f"unknown top-k method {params.method}")
