"""Coarse routing: prune segments before the exact match phase.

The counterpart of `repro/core/routing.py`.  At seal time each segment gets a
compact `SegmentSummary` -- per-column min/max bounds, a centroid over its
signatures, and (for the bucketed engines) a per-column bucket-occupancy
sketch -- and at query time a `Router` scores the query signatures against
all summaries to decide which segments can still hold a top-k member.

The router's contract is an *upper bound*, not an estimate: for every engine
``upper_bound(summary, queries)[q] >= max_i count(row_i, query_q)`` over the
segment's rows.  That makes the three routing modes (`core/plan.py` threads
them through `QueryPlan.routing`) well defined:

  NONE             full scan (the default; exact by construction).
  ROUTED           scan only the selected segments -- approximate: a true
                   top-k member in a skipped segment is lost.
  ROUTED_VERIFIED  scan the selected segments, then compare the result's
                   k-th count with the skipped segments' upper bounds; if any
                   skipped segment could still contribute (UB >= threshold:
                   a tied count with a smaller id displaces the k-th slot
                   under the (count desc, id asc) order), fall back to the
                   full scan.  Equal to NONE bit for bit.

Per-engine bounds (all on the canonical WIDE arrays -- summaries are built
from the prepared tensor *before* packing):

  EQ / TANIMOTO   UB = number of query columns whose bucket is occupied
                  anywhere in the segment's column (an occupancy sketch of
                  `OCC_BUCKETS` bits a column, values hashed by modulo --
                  collisions only over-count).
  RANGE           UB = #attributes whose query interval overlaps the
                  segment's per-column [min, max].
  MINSUM          sum_j min(d_j, q_j) <= sum_j min(col_max_j, q_j).
  IP              sum_j d_j*q_j <= sum_j max(col_max_j*q_j, col_min_j*q_j).
  COSINE          UB = #columns whose sign range contains the query sign.

The summary is a host-side numpy record and the router runs on the host, as
in the reference, and line for line: `Router.select` breaks equal bounds by
`1 / (2 + dist)`, a float64 square root of a sum whose order numpy fixes, so
the selected mask is the reference's bit for bit.  What differs is where a
summary is *built*: `summarize` on a tensor reduces on the tensor's device
(column min / max, an int64 column sum, the occupancy by a scatter) and
moves only the summary to the host, instead of copying the segment there.
The centroid stays exact: the prepared arrays hold whole numbers, and an
int64 column sum divided by n in float64 gives the bits of the reference's
float64 `mean` whenever every partial sum stays below 2**53; otherwise (or
for a floating corpus with fractions) the summary is built on the host, as
the reference builds it.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.types import Engine
from repro_torch.device import int64_sum

# Bucket-occupancy sketch width for the collision engines (EQ/TANIMOTO).
# Values hash by modulo; a collision marks an extra bucket occupied, which
# can only raise the bound -- soundness never depends on this constant.
OCC_BUCKETS = 2048

# Engines whose counts are per-column bucket collisions (occupancy sketch).
_BUCKETED = (Engine.EQ, Engine.TANIMOTO)

# |partial sums| below this convert to float64 exactly, in any order
_EXACT_SUM = 2 ** 53

# elements a chunk of the occupancy scatter indexes at once (int64 indices)
_SCATTER_CHUNK = 1 << 23


class Routing(str, enum.Enum):
    """Routing mode of a planned search (see module docstring)."""

    NONE = "none"                        # full scan, bit-exact
    ROUTED = "routed"                    # prune, approximate
    ROUTED_VERIFIED = "routed_verified"  # prune + threshold-verify + fallback


@dataclasses.dataclass(frozen=True)
class SegmentSummary:
    """Compact per-segment routing summary, built once at seal time.

    All arrays are host-side numpy: the router runs on the host before any
    part is matched, so skipped segments never touch the device."""

    engine: Engine
    n_rows: int
    col_min: np.ndarray                  # [width] float64, per-column min
    col_max: np.ndarray                  # [width] float64, per-column max
    centroid: np.ndarray                 # [width] float64, column means
    occupancy: Optional[np.ndarray] = None  # [width, OCC_BUCKETS] bool


def _summarize_host(engine: Engine, arr: np.ndarray) -> SegmentSummary:
    """The reference's summary, computed the reference's way on the host."""
    occ = None
    if engine in _BUCKETED:
        width = arr.shape[1]
        occ = np.zeros((width, OCC_BUCKETS), dtype=bool)
        cols = np.broadcast_to(np.arange(width)[None, :], arr.shape)
        occ[cols.ravel(), np.mod(arr.astype(np.int64), OCC_BUCKETS).ravel()] = True
    vals = arr.astype(np.float64)
    return SegmentSummary(
        engine=engine,
        n_rows=int(arr.shape[0]),
        col_min=vals.min(axis=0),
        col_max=vals.max(axis=0),
        centroid=vals.mean(axis=0),
        occupancy=occ,
    )


def _occupancy(x: torch.Tensor) -> torch.Tensor:
    """bool [width, OCC_BUCKETS] on x's device: bucket remainder(x, 2048) of
    each column marked.  `remainder`, not `fmod`: an empty minhash row's
    0xFFFFFFFF is -1 as int32, and numpy's `mod` puts it in bucket 2047."""
    n, width = x.shape
    occ = torch.zeros(width * OCC_BUCKETS, dtype=torch.bool, device=x.device)
    base = torch.arange(width, dtype=torch.int64, device=x.device) * OCC_BUCKETS
    step = max(1, _SCATTER_CHUNK // max(width, 1))
    for lo in range(0, n, step):
        bucket = torch.remainder(x[lo:lo + step].to(torch.int64), OCC_BUCKETS)
        occ.index_fill_(0, (bucket + base).reshape(-1), True)
    return occ.reshape(width, OCC_BUCKETS)


def _summarize_tensor(engine: Engine, x: torch.Tensor) -> SegmentSummary:
    """The summary reduced on x's device; only the summary moves to the
    host.  Falls back to the host route where the int64 sum could not give
    the reference's float64 mean bit for bit."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    n = int(x.shape[0])
    lo, hi = x.amin(dim=0), x.amax(dim=0)
    col_min = lo.cpu().numpy().astype(np.float64)
    col_max = hi.cpu().numpy().astype(np.float64)
    # float inputs must be whole numbers for the integer sum; NaN / inf fail
    # the magnitude test below and take the host route
    whole = not x.is_floating_point() or bool(torch.equal(x, torch.trunc(x)))
    with np.errstate(invalid="ignore", over="ignore"):
        peak = float(max(np.abs(col_min).max(), np.abs(col_max).max()))
    if not whole or not peak * n < _EXACT_SUM:
        return _summarize_host(engine, x.cpu().numpy())
    sums = int64_sum(x, dim=0).cpu().numpy()
    occ = _occupancy(x).cpu().numpy() if engine in _BUCKETED else None
    return SegmentSummary(
        engine=engine, n_rows=n, col_min=col_min, col_max=col_max,
        # numpy's mean divides its float64 sum by n in float64: the same
        # correctly rounded quotient of the same (exact) sum
        centroid=sums.astype(np.float64) / n,
        occupancy=occ,
    )


def summarize(engine: Engine | str, wide_data) -> SegmentSummary:
    """Summarise one segment's *prepared WIDE* array (call before pack_data,
    never on a packed array -- a packed width is words/bytes, not columns).
    A tensor is reduced on its device; anything else on the host."""
    engine = Engine(engine)
    shape = tuple(wide_data.shape) if hasattr(wide_data, "shape") else np.shape(wide_data)
    if len(shape) != 2 or shape[0] < 1:
        raise ValueError(f"summarize needs a non-empty [N, width] array, "
                         f"got shape {shape}")
    if isinstance(wide_data, torch.Tensor):
        return _summarize_tensor(engine, wide_data)
    return _summarize_host(engine, np.asarray(wide_data))


def merge_summaries(a: SegmentSummary, b: SegmentSummary) -> SegmentSummary:
    """Summary of the concatenation of two segments (compaction): bounds
    widen elementwise, occupancies OR, centroids merge row-weighted.  The
    merged bound is >= each source bound, so it stays a sound upper bound."""
    if a.engine is not b.engine:
        raise ValueError(f"cannot merge summaries of engines "
                         f"{a.engine.value!r} and {b.engine.value!r}")
    if a.col_min.shape != b.col_min.shape:
        raise ValueError(f"cannot merge summaries of widths "
                         f"{a.col_min.shape} and {b.col_min.shape}")
    rows = a.n_rows + b.n_rows
    return SegmentSummary(
        engine=a.engine,
        n_rows=rows,
        col_min=np.minimum(a.col_min, b.col_min),
        col_max=np.maximum(a.col_max, b.col_max),
        centroid=(a.centroid * a.n_rows + b.centroid * b.n_rows) / rows,
        occupancy=None if a.occupancy is None else (a.occupancy | b.occupancy),
    )


def _query_matrix(engine: Engine, queries: Any) -> np.ndarray:
    """Canonical WIDE queries -> one [Q, width] float64 point matrix (RANGE
    queries collapse to their interval midpoints -- centroid affinity only)."""
    if engine is Engine.RANGE:
        lo, hi = queries
        return (np.asarray(lo, dtype=np.float64)
                + np.asarray(hi, dtype=np.float64)) / 2.0
    return np.asarray(queries, dtype=np.float64)


def upper_bound(summary: SegmentSummary, queries: Any) -> np.ndarray:
    """Per-query upper bound on the match count any row of this segment can
    reach: float64 [Q].  Sound for every registered engine (see the module
    docstring).  `queries` are host arrays (numpy; RANGE an (lo, hi) pair)."""
    eng = summary.engine
    if eng in _BUCKETED:
        q = np.asarray(queries)
        if summary.occupancy is None:
            raise ValueError(f"summary for engine {eng.value!r} carries no "
                             f"occupancy sketch (merged from a foreign one?)")
        cols = np.arange(q.shape[1])
        hit = summary.occupancy[cols[None, :],
                                np.mod(q.astype(np.int64), OCC_BUCKETS)]
        return hit.sum(axis=1).astype(np.float64)
    if eng is Engine.RANGE:
        lo = np.asarray(queries[0], dtype=np.float64)
        hi = np.asarray(queries[1], dtype=np.float64)
        overlap = (lo <= summary.col_max[None, :]) & (hi >= summary.col_min[None, :])
        return overlap.sum(axis=1).astype(np.float64)
    q = np.asarray(queries, dtype=np.float64)
    if eng is Engine.MINSUM:
        return np.minimum(q, summary.col_max[None, :]).sum(axis=1)
    if eng is Engine.IP:
        return np.maximum(q * summary.col_max[None, :],
                          q * summary.col_min[None, :]).sum(axis=1)
    if eng is Engine.COSINE:
        inside = (q >= summary.col_min[None, :]) & (q <= summary.col_max[None, :])
        return inside.sum(axis=1).astype(np.float64)
    raise ValueError(f"no routing bound registered for engine {eng.value!r}")


@dataclasses.dataclass
class Router:
    """Scores query signatures against all segment summaries and picks the
    segments that can contain the top-k.  Built by `SegmentedIndex.router()`;
    consumed by the routed executors in core/plan.py."""

    engine: Engine
    summaries: list[SegmentSummary]

    def __post_init__(self):
        self.engine = Engine(self.engine)
        if not self.summaries:
            raise ValueError("Router needs at least one segment summary")
        for s in self.summaries:
            if s.engine is not self.engine:
                raise ValueError(f"summary engine {s.engine.value!r} != "
                                 f"router engine {self.engine.value!r}")

    @property
    def n_segments(self) -> int:
        return len(self.summaries)

    @property
    def part_rows(self) -> tuple[int, ...]:
        return tuple(s.n_rows for s in self.summaries)

    def default_nprobe(self) -> int:
        """IVF-style default probe width: ~sqrt(#segments)."""
        return max(1, math.isqrt(self.n_segments - 1) + 1)

    def upper_bounds(self, queries: Any) -> np.ndarray:
        """float64 [Q, S]: per-(query, segment) count upper bounds."""
        return np.stack([upper_bound(s, queries) for s in self.summaries],
                        axis=1)

    def select(self, queries: Any, nprobe: Optional[int] = None,
               ubs: Optional[np.ndarray] = None,
               ) -> tuple[np.ndarray, np.ndarray]:
        """(segment mask bool [S], upper bounds float64 [Q, S]).

        Each query ranks segments by (upper bound, centroid affinity) -- the
        affinity is a strict sub-unit tiebreak, so it reorders only segments
        whose integer bounds tie -- and keeps its top `nprobe`; the mask is
        the union over the query batch (the host loop runs the whole batch
        against every scanned part)."""
        if ubs is None:
            ubs = self.upper_bounds(queries)
        nprobe = self.default_nprobe() if nprobe is None else int(nprobe)
        if nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        nprobe = min(nprobe, self.n_segments)
        q = _query_matrix(self.engine, queries)
        # affinity in (0, 0.5]: closer centroid wins equal-bound ties
        cent = np.stack([s.centroid for s in self.summaries], axis=0)  # [S, w]
        dist = np.sqrt(((q[:, None, :] - cent[None, :, :]) ** 2).sum(axis=2))
        score = ubs + 1.0 / (2.0 + dist)
        top = np.argsort(-score, axis=1, kind="stable")[:, :nprobe]
        mask = np.zeros(self.n_segments, dtype=bool)
        mask[np.unique(top)] = True
        return mask, ubs


# ---------------------------------------------------------------------------
# Shard-mask helpers for the DISTRIBUTED layout (segments -> mesh shards)
# ---------------------------------------------------------------------------

def shard_mask(part_rows: Sequence[int], segment_mask: np.ndarray,
               n_local: int, n_shards: int) -> np.ndarray:
    """bool [n_shards]: a shard is active iff it overlaps any routed segment
    (segments concatenate in global-id order; each shard holds `n_local`
    consecutive rows).  The padded tail past the last segment belongs to no
    segment and activates nothing."""
    n_local = max(int(n_local), 1)
    active = np.zeros(int(n_shards), dtype=bool)
    offset = 0
    for keep, rows in zip(np.asarray(segment_mask), part_rows):
        if keep:
            active[offset // n_local:(offset + rows - 1) // n_local + 1] = True
        offset += rows
    return active


def segments_needing_verify(part_rows: Sequence[int], shard_active: np.ndarray,
                            n_local: int) -> np.ndarray:
    """bool [S]: segments with ANY overlapping inactive shard -- the ones a
    ROUTED_VERIFIED distributed search must check the threshold against.
    (A segment overlapping only active shards was fully scanned and needs no
    verify.)"""
    n_local = max(int(n_local), 1)
    shard_active = np.asarray(shard_active).astype(bool)
    out = np.zeros(len(part_rows), dtype=bool)
    offset = 0
    for i, rows in enumerate(part_rows):
        out[i] = not shard_active[offset // n_local:
                                  (offset + rows - 1) // n_local + 1].all()
        offset += rows
    return out
