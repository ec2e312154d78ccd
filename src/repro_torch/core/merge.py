"""Hierarchical top-k merge (paper section III-D's host merge, generalised).

The paper's multiple-loading strategy searches index parts independently and
merges per-part top-k results on the CPU.  Every part produces a cap-sized
candidate buffer (c-PQ Hash Table) and buffers are merged
pairwise/hierarchically -- the merge of two valid top-k buffers is a valid
top-k buffer of the union (counts are per-object totals when objects are
*partitioned* across parts, so no cross-part count summation is needed).

These primitives are called only from the unified executor (core/plan.py),
which picks the strategy per layout: `merge_ragged` for host-streamed
heterogeneous parts; `merge_topk` / `tree_merge` serve the stacked and
sharded layouts.

merge_topk    -- merge of stacked per-part results.
tree_merge    -- log2(S) pairwise merge (the collective-friendly schedule).
"""
from __future__ import annotations

import torch

from repro_torch.core import cpq as _cpq
from repro_torch.core.types import TopKResult


def merge_topk(ids: torch.Tensor, counts: torch.Tensor, k: int) -> TopKResult:
    """Merge per-part results.  ids/counts: int32 [S, Q, kp] (part-LOCAL top-k,
    ids already globalised) -> overall top-k [Q, k]."""
    s, q, kp = ids.shape
    flat_ids = ids.permute(1, 0, 2).reshape(q, s * kp)
    flat_counts = counts.permute(1, 0, 2).reshape(q, s * kp)
    # genielint: ignore[executor-sovereignty] -- the port's own executor family
    out_ids, out_counts = _cpq.topk_from_candidates(flat_ids, flat_counts, k)
    return TopKResult(ids=out_ids, counts=out_counts, threshold=out_counts[:, -1])


def merge_ragged(ids_list, counts_list, k: int) -> TopKResult:
    """Merge per-part top-k buffers of *heterogeneous* widths.

    ids_list/counts_list: per-part int32 [Q, kp_i] buffers (kp_i may differ --
    a part smaller than k contributes only min(k, n_part) candidates), ids
    already globalised.  Parts must partition the object set and arrive in
    ascending global-id order: the flattened candidate row is then globally
    id-ascending within equal counts, so the stable selection reproduces the
    monolithic (count desc, id asc) ordering exactly.
    """
    ids = torch.cat(list(ids_list), dim=-1)
    counts = torch.cat(list(counts_list), dim=-1)
    if ids.shape[-1] < k:  # fewer total candidates than k: pad empty slots
        pad = torch.full((ids.shape[0], k - ids.shape[-1]), -1,
                         dtype=torch.int32, device=ids.device)
        ids = torch.cat([ids, pad], dim=-1)
        counts = torch.cat([counts, pad], dim=-1)
    # genielint: ignore[executor-sovereignty] -- the port's own executor family
    out_ids, out_counts = _cpq.topk_from_candidates(ids, counts, k)
    return TopKResult(ids=out_ids, counts=out_counts, threshold=out_counts[:, -1])


def merge_two(
    ids_a: torch.Tensor, counts_a: torch.Tensor, ids_b: torch.Tensor, counts_b: torch.Tensor, k: int
):
    """Pairwise merge of two [Q, k] buffers -> [Q, k]."""
    ids = torch.cat([ids_a, ids_b], dim=-1)
    counts = torch.cat([counts_a, counts_b], dim=-1)
    # genielint: ignore[executor-sovereignty] -- the port's own executor family
    return _cpq.topk_from_candidates(ids, counts, k)


def tree_merge(ids: torch.Tensor, counts: torch.Tensor, k: int):
    """log2(S) pairwise merge of [S, Q, kp] buffers (ids globalised).

    Mirrors the recursive-doubling schedule a collective merge uses;
    produces identical results to merge_topk (tested).
    """
    s = ids.shape[0]
    while s > 1:
        half = (s + 1) // 2
        a_ids, a_cnt = ids[:half], counts[:half]
        b_ids = torch.cat([ids[half:], torch.full_like(ids[: 2 * half - s], -1)], dim=0)
        b_cnt = torch.cat([counts[half:], torch.full_like(counts[: 2 * half - s], -1)], dim=0)
        ids, counts = merge_two(a_ids, a_cnt, b_ids, b_cnt,
                                min(k, a_ids.shape[-1] + b_ids.shape[-1]))
        s = half
    # genielint: ignore[executor-sovereignty] -- the port's own executor family
    out_ids, out_counts = _cpq.topk_from_candidates(ids[0], counts[0], k)
    return TopKResult(ids=out_ids, counts=out_counts, threshold=out_counts[:, -1])
