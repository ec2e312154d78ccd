"""SPQ baseline: iterative bucket k-selection (paper appendix, after [9]).

This is the "GPU-SPQ / GEN-SPQ" competitor the paper benchmarks against
(Figs 9/10/13, Table IV): extract the top-k of a value array by repeatedly
partitioning the active value range into B buckets, locating the bucket that
contains the k-th largest element, saving everything above it, and recursing
into that bucket.  The paper reports convergence in 2-3 iterations; we run a
fixed number of narrowing iterations (enough for integer counts to collapse
the bucket width below 1) and then reuse the same threshold compaction as
c-PQ, which keeps the comparison about the *selection strategy* (range
narrowing over N vs. the bounded-count Gate).

The arithmetic is float32 step for step as in the JAX package, so the
threshold comes out the same.
"""
from __future__ import annotations

import torch

from repro_torch.core import cpq as _cpq
from repro_torch.core.types import SearchParams, TopKResult


def spq_select(
    counts: torch.Tensor,
    params: SearchParams,
    n_buckets: int = 32,
    n_iters: int = 4,
) -> TopKResult:
    """Bucket k-selection: counts int [Q, N] -> exact top-k.  The final
    compaction is c-PQ's (`cpq._compact`: the CUDA kernel's wrapper on the
    kernel path)."""
    q, n = counts.shape
    dev = counts.device
    c = counts.to(torch.float32)
    k = params.k

    lo = c.min(dim=-1).values                            # [Q] active range lower
    hi = c.max(dim=-1).values                            # [Q] active range upper
    saved = torch.zeros((q,), dtype=torch.int32, device=dev)  # elems strictly above range
    rows = torch.arange(q, device=dev)

    for _ in range(n_iters):
        width = torch.clamp((hi - lo) / n_buckets, min=1e-6)
        # bucket id of each element; elements outside [lo, hi] are clamped away
        b = torch.clamp(((c - lo[:, None]) / width[:, None]).to(torch.int32), -1, n_buckets)
        in_range = (c >= lo[:, None]) & (c <= hi[:, None])
        # out-of-range elements go to one extra bin that is sliced off (the
        # scatter form of the reference's one-hot sum, whose [Q, N, B] temp
        # eager PyTorch would have to materialise)
        b = torch.where(in_range, torch.clamp(b, max=n_buckets - 1), n_buckets)
        hist = torch.zeros((q, n_buckets + 1), dtype=torch.int32, device=dev)
        hist.scatter_add_(1, b.to(torch.int64),
                          torch.ones((), dtype=torch.int32, device=dev).expand(q, n))
        hist = hist[:, :n_buckets]                        # [Q, B]
        # suffix count of elements in bucket >= t
        suffix = torch.flip(torch.cumsum(torch.flip(hist, (-1,)), -1), (-1,)).to(torch.int32)
        need = k - saved                                  # remaining to find
        # selected bucket: largest b* with suffix[b*] >= need
        ok = suffix >= need[:, None]
        bstar = torch.where(
            ok.any(dim=-1),
            n_buckets - 1 - torch.argmax(torch.flip(ok, (-1,)).to(torch.int8), dim=-1),
            0,
        )
        has_above = bstar + 1 < n_buckets
        above = torch.where(
            has_above,
            suffix[rows, torch.clamp(bstar + 1, max=n_buckets - 1)],
            0,
        )
        saved = saved + above
        new_lo = lo + bstar.to(torch.float32) * width
        new_hi = new_lo + width
        lo, hi = new_lo, new_hi

    # For integer counts the final bucket width < 1, so ceil(lo) is the k-th
    # value; select with the shared compaction machinery.
    threshold = torch.ceil(lo - 1e-4).to(torch.int32)
    cand_ids, cand_vals = _cpq._compact(counts, threshold, params)
    # genielint: ignore[executor-sovereignty] -- the port's own executor family
    ids, vals = _cpq.topk_from_candidates(cand_ids, cand_vals, params.k)
    return TopKResult(ids=ids, counts=vals, threshold=threshold)
