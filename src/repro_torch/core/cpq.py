"""c-PQ: Count Priority Queue (paper section III-C), dense formulation.

The paper's c-PQ keeps a dense low-bit Bitmap Counter for every object, a Gate
(ZipperArray ZA + AuditThreshold AT) fed by atomic updates, and a small Hash
Table holding only objects whose count passed AT.  Theorem 3.1: when the scan
finishes, ZA[AT] < k <= ZA[AT-1], the k-th match count MC_k == AT - 1, and the
top-k candidates all sit in the Hash Table (|HT| = O(k * AT)).

Counts live in a bounded domain [0, max_count], so the Gate state is
reconstructed *exactly* from a count histogram -- ZA[t] == #(count_n >= t) ==
suffix-sum of the histogram:

  phase 1 (histogram):  hist[q, t] = #(counts[q, n] == t)   (CUDA kernel)
  phase 2 (gate):       AT = min(t >= 1 : ZA[t] < k);  threshold = AT - 1
  phase 3 (hash table): masked two-class compaction (strict > threshold first,
                        then ties == threshold) into a fixed buffer of size cap
                        -- the Hash-Table analogue; a single scan, no sort of N.

Only the final cap-sized buffer (cap ~ 2k << N) is ordered, reproducing the
paper's "scan the small HT once" property.

Ordering contract: `(count desc, id asc)`.  `torch.topk` and the default
`torch.sort` promise no order among equals, so every ordering step here is a
stable sort over a row that is already id-ascending.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core.types import SearchParams, TopKResult


def count_histogram(counts: torch.Tensor, max_count: int, bin_chunk: int = 8) -> torch.Tensor:
    """hist[q, t] = #{n : counts[q, n] == t},  t in [0, max_count].

    A loop over bin chunks keeps the one-hot temp at [Q, N, bin_chunk] (a
    full [Q, N, max_count+1] one-hot would be tens of GB at paper scale; the
    CUDA kernel streams N instead)."""
    nbins = max_count + 1
    c = counts.to(torch.int32)
    parts = []
    for start in range(0, nbins, bin_chunk):
        bins = torch.arange(start, min(start + bin_chunk, nbins),
                            dtype=torch.int32, device=c.device)
        parts.append((c[..., None] == bins).sum(dim=1, dtype=torch.int32))
    return torch.cat(parts, dim=1)


def zipper_array(hist: torch.Tensor) -> torch.Tensor:
    """ZA[q, t] = #{n : count >= t} (suffix sum of hist over the count axis)."""
    return torch.flip(torch.cumsum(torch.flip(hist, dims=(-1,)), dim=-1), dims=(-1,))


def audit_threshold(hist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate: AT[q] = min{t >= 1 : ZA[t] < k} (== max_count+1 when none).

    Returns (at, threshold) with threshold = AT - 1 == MC_k (Theorem 3.1).
    """
    za = zipper_array(hist)                      # [Q, max_count+1]
    max_count = hist.shape[-1] - 1
    if max_count == 0:                           # no t >= 1 exists
        at = torch.ones(hist.shape[0], dtype=torch.int32, device=hist.device)
        return at, at - 1
    below = za[:, 1:] < k                        # t = 1 .. max_count
    any_below = below.any(dim=-1)
    # argmax returns the first maximal index: the first t with ZA[t] < k
    first = torch.argmax(below.to(torch.int8), dim=-1) + 1
    at = torch.where(any_below, first, max_count + 1).to(torch.int32)
    return at, at - 1


def _compact_candidates(
    counts: torch.Tensor, threshold: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-class masked compaction into a cap-sized buffer per query.

    Objects with count > threshold ("strict", provably < k of them by the Gate)
    are written first; ties (== threshold) fill the remaining slots in id order
    (the paper breaks ties randomly).  Returns (ids [Q, cap], vals [Q, cap]),
    empty slots marked id=-1, val=-1.

    Everything that does not fit is scattered into one extra slot, column
    `cap`, which is sliced off: every position below `cap` is written at most
    once, so the result does not depend on the order of the writes.
    """
    q, n = counts.shape
    c = counts.to(torch.int32)
    thr = threshold[:, None]
    strict = c > thr
    tie = c == thr
    n_strict = strict.sum(dim=-1, keepdim=True, dtype=torch.int32)
    pos = torch.where(tie, n_strict + torch.cumsum(tie, dim=-1, dtype=torch.int32) - 1, cap)
    del tie
    pos = torch.where(strict, torch.cumsum(strict, dim=-1, dtype=torch.int32) - 1, pos)
    del strict
    pos = pos.clamp_(max=cap).to(torch.int64)    # cap slot == drop; scatter_ indexes in int64
    ids = torch.arange(n, dtype=torch.int32, device=c.device)[None, :].expand(q, n)
    out_ids = torch.full((q, cap + 1), -1, dtype=torch.int32, device=c.device)
    out_vals = torch.full((q, cap + 1), -1, dtype=torch.int32, device=c.device)
    out_ids.scatter_(1, pos, ids)
    out_vals.scatter_(1, pos, c)
    return out_ids[:, :cap], out_vals[:, :cap]


def _compact(counts: torch.Tensor, threshold: torch.Tensor,
             params: SearchParams) -> tuple[torch.Tensor, torch.Tensor]:
    """`_compact_candidates` into `params.cap()` slots; on the kernel path
    (`params.use_kernel`) the CUDA kernel's wrapper, which takes the plain
    version for a CPU tensor."""
    if not params.use_kernel:
        return _compact_candidates(counts, threshold, params.cap())
    # imported at the call: kernels/cpq_compact and kernels/cpq_hist import this module
    from repro_torch.kernels.cpq_compact import cpq_compact

    return cpq_compact(counts, threshold, params.cap())


def topk_from_candidates(ids: torch.Tensor, vals: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Order a small candidate buffer by (count desc, id asc) and take k.

    This is the "scan the Hash Table once" step: the buffer is tiny (cap or a
    merge of per-shard caps), so the sort cost is O(cap log cap) independent
    of N.
    """
    vals = vals.to(torch.int32)
    # A stable descending sort keeps id-ascending order within equal counts
    # (buffers are filled in id order).
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    top = order[..., :k]
    return torch.gather(ids, -1, top), torch.gather(vals, -1, top)


def cpq_select(counts: torch.Tensor, params: SearchParams) -> TopKResult:
    """Exact top-k by match count via the c-PQ gate.  counts: int [Q, N].

    On the kernel path (`params.use_kernel`) the histogram and the
    compaction are the CUDA kernels' wrappers (kernels/cpq_hist,
    kernels/cpq_compact), which take their plain versions for a CPU tensor;
    otherwise `count_histogram` and `_compact_candidates`.

    Spans `cpq.gate` (histogram and threshold), `cpq.compact` and
    `cpq.order` (repro_torch.trace); while they are on, the gate's counter
    `cpq.passed` is the number of objects it lets through, ZA[threshold]
    summed over the queries.
    """
    with trace.span("cpq.gate"):
        if params.use_kernel:
            from repro_torch.kernels import ops as kops

            hist = kops.cpq_hist(counts, params.max_count)
        else:
            hist = count_histogram(counts, params.max_count)
        _, threshold = audit_threshold(hist, params.k)
        if trace.on():
            passed = zipper_array(hist).gather(1, threshold[:, None].to(torch.int64))
            trace.add("cpq.passed", passed.sum())
    with trace.span("cpq.compact"):
        cand_ids, cand_vals = _compact(counts, threshold, params)
    with trace.span("cpq.order"):
        # genielint: ignore[executor-sovereignty] -- the port's own executor family
        ids, vals = topk_from_candidates(cand_ids, cand_vals, params.k)
    return TopKResult(ids=ids, counts=vals, threshold=threshold)


def sort_select(counts: torch.Tensor, params: SearchParams) -> TopKResult:
    """Baseline: full sort-based top-k (a stable descending sort over all N,
    which puts the lower id first among equal counts)."""
    if params.k > counts.shape[-1]:
        raise ValueError(
            f"sort_select: k={params.k} exceeds the {counts.shape[-1]} "
            f"objects of this part"
        )
    vals, ids = torch.sort(counts.to(torch.int32), dim=-1, descending=True, stable=True)
    # copies, so the two [Q, N] sort buffers are not kept alive by views
    vals = vals[:, :params.k].contiguous()
    ids = ids[:, :params.k].to(torch.int32)
    return TopKResult(ids=ids, counts=vals, threshold=vals[:, -1])
