"""Unified top-k selection: one pipeline for every search path.

`select_topk` dispatches on `SearchParams.method` (c-PQ gate / SPQ bucket
narrowing / full sort) and optionally consumes the histogram of the CUDA
kernel (kernels/cpq_hist) so the Gate reconstruction reads the counts matrix
once, in a kernel, on the kernel path; there the candidates of c-PQ and SPQ
are compacted by the CUDA kernel of kernels/cpq_compact too.

Its only caller is the unified executor (core/plan.py) -- every layout
selects through the same per-part step there, which is what makes the
selection strategy a *parameter* of a search rather than a property of the
call site.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import trace
from repro_torch.core import cpq as _cpq
from repro_torch.core import spq as _spq
from repro_torch.core.types import SearchParams, TopKMethod, TopKResult


def select_topk(
    counts: torch.Tensor,
    params: SearchParams,
    hist: Optional[torch.Tensor] = None,
    use_fused_hist: bool = False,
) -> TopKResult:
    """Exact top-k by match count.  counts: int [Q, N] -> TopKResult [Q, k].

    hist:           precomputed count histogram [Q, max_count + 1] (optional).
    use_fused_hist: the kernel path: compute the histogram with the CUDA
                    kernel when `hist` is not supplied, and compact with the
                    CUDA kernel (plain-path callers keep the plain PyTorch
                    histogram and compaction).
    """
    compact_fn = None
    if use_fused_hist:
        from repro_torch.kernels.cpq_compact import cpq_compact as compact_fn
    if params.method == TopKMethod.CPQ:
        hist_fn = None
        if hist is None and use_fused_hist:
            from repro_torch.kernels import ops as kops

            hist_fn = kops.cpq_hist
        return _cpq.cpq_select(counts, params, hist=hist, hist_fn=hist_fn,
                               compact_fn=compact_fn)
    if params.method == TopKMethod.SPQ:
        with trace.span("spq_select"):
            return _spq.spq_select(counts, params, compact_fn=compact_fn)
    if params.method == TopKMethod.SORT:
        with trace.span("sort_select"):
            return _cpq.sort_select(counts, params)
    raise ValueError(f"unknown top-k method {params.method}")
