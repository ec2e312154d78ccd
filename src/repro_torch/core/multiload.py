"""Multiple loading (paper section III-D): search datasets larger than device
memory by streaming index parts and merging per-part top-k results.

The counterpart of `repro/core/multiload.py`.  Both entry points are thin
adapters over the planner (core/plan.py): they describe the part layout as a
MULTILOAD `QueryPlan` and delegate to the shared executor, which owns match
dispatch, pad masking, per-part k clamping, selection and the merge.

`multiload_search_host` is the literal paper strategy (`host_loop=True`
plans): parts live in host memory -- numpy arrays or CPU tensors, pinned for
the copy to overlap the match -- and are copied to the queries' device one
at a time, part i + 1 on a side stream while part i is matched.
`multiload_search` walks a stacked [C, Nc, ...] tensor that is already on
the device, chunk by chunk, with an incremental pairwise merge.

The match function uses the canonical registry signature
``match_fn(data, queries) -> counts`` (core/engines.py) -- an Engine, its
name, a MatchModel or a raw callable -- so every registered engine streams
the same way; queries may be a tensor or a tuple of tensors (RANGE passes
the ``(lo, hi)`` pair).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core import plan as _plan
from repro_torch.core.types import SearchParams, TopKResult

# The pad masks live in the executor module (core/plan.py), the only code
# that calls them.  The reference module exports these names as back-compat
# aliases, so the port keeps them: code written against it ports unchanged.
_mask_pad_counts = _plan._mask_pad_counts
_mask_invalid = _plan._mask_invalid


def _multiload_plan(part_rows, params: SearchParams, match_fn,
                    n_objects: Optional[int], host_loop: bool) -> _plan.QueryPlan:
    return _plan.plan_search(
        match_fn, params.k, params.max_count, layout=_plan.Layout.MULTILOAD,
        part_rows=part_rows, n_objects=n_objects, method=params.method,
        candidate_cap=params.candidate_cap, use_kernel=params.use_kernel,
        host_loop=host_loop,
    )


def multiload_search(
    chunks: torch.Tensor,
    queries: Any,
    params: SearchParams,
    match_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    n_objects: Optional[int] = None,
) -> TopKResult:
    """Search C stacked index parts with a scanned merge.

    chunks:    [C, Nc, ...] stacked per-part data matrices.
    queries:   canonical queries (one [Q, m] tensor for EQ / MINSUM / IP, an
               (lo, hi) pair for RANGE).
    match_fn:  (data [Nc, ...], queries) -> counts [Q, Nc].
    n_objects: true object count; rows with global id >= n_objects are
               padding from an uneven split and are masked out.
    """
    part_rows = (int(chunks.shape[1]),) * int(chunks.shape[0])
    plan = _multiload_plan(part_rows, params, match_fn, n_objects, host_loop=False)
    return _plan.execute(plan, chunks, queries)


def multiload_search_host(parts, queries, params: SearchParams, match_fn,
                          n_objects: Optional[int] = None) -> TopKResult:
    """Host-loop variant: `parts` is a list of per-part arrays (numpy, CPU
    tensors -- pinned ones overlap their copy with the match -- or device
    tensors) copied to the queries' device one at a time.

    Parts may have *heterogeneous* sizes (SegmentedIndex streams its sealed
    segments through here); a part smaller than k contributes only
    min(k, n_part) candidates.
    """
    part_rows = tuple(int(p.shape[0]) for p in parts)
    plan = _multiload_plan(part_rows, params, match_fn, n_objects, host_loop=True)
    return _plan.execute(plan, list(parts), queries)
