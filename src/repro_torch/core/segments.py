"""SegmentedIndex: incremental append + compaction over immutable segments.

Each `add()` seals the batch into an immutable per-segment `GenieIndex`
(O(batch) device work, no rebuild or re-upload of earlier batches),
`search()` builds a SEGMENTED QueryPlan over the sealed parts and delegates
to the unified executor (core/plan.py) which matches, selects, and merges the
cap-sized candidate buffers exactly, and `compact(max_segments)` coalesces
adjacent segments so steady-state search cost stays flat as the corpus grows.

The merge is exact, not approximate: segments *partition* the object set, so
an object's match count is computed entirely inside its own segment.  Any
global top-k member is a top-min(k, n_seg) member of its segment, hence
per-segment buffers of width min(k, n_seg) always contain the global top-k,
and the merged ordering (count desc, global id asc) is identical to a
monolithic search -- ids and counts match exactly.

Compaction only ever merges *adjacent* segments: global ids are assigned by
cumulative segment offset in append order, and concatenating neighbours
preserves that order, so compaction never remaps an id.

    seg = SegmentedIndex(Engine.EQ)
    seg.add(sigs_batch_0)              # seals segment 0
    seg.add(sigs_batch_1)              # seals segment 1 -- no rebuild
    res = seg.search(queries, k=10)    # == monolithic GenieIndex search
    seg.compact(max_segments=1)        # coalesce; ids unchanged

Segments are sealed in the index's signature layout: PACKED segments hold
packed rows (COSINE words, TANIMOTO uint8 buckets), a compaction concatenates
them row-wise (still valid packed rows), and `search` packs the queries.

`search_multiload` streams the segments through the MULTILOAD host loop
(paper section III-D).  Both searches route (core/routing.py): `router()`
builds a Router over the segments' seal-time summaries, which compaction
merges, and `routing="routed"` / `"routed_verified"` with `nprobe=` skip the
segments it rules out.  They take the reference's `tile_overrides` /
`autotune` keywords (core/autotune.py); a tuned entry that prefers the
MULTILOAD host loop switches `search` to `search_multiload`, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import autotune as _autotune
from repro_torch.core import engines as _engines
from repro_torch.core import plan as _plan
from repro_torch.core import routing as _routing
from repro_torch.core.index import GenieIndex
from repro_torch.core.types import (Engine, IndexStats, SignatureLayout,
                                    TopKMethod, TopKResult)
from repro_torch.device import DeviceLike, resolve_device, synchronize


def even_segments(n_objects: int, n_segments: int) -> list[int]:
    """Row counts of an even split of `n_objects` into `n_segments` parts."""
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    base, rem = divmod(n_objects, n_segments)
    return [base + (1 if i < rem else 0) for i in range(n_segments)]


def layout_accounting(segment_rows, row_bytes: int) -> dict:
    """Host-side accounting for a segmented layout."""
    rows = [int(r) for r in segment_rows]
    return dict(
        n_segments=len(rows),
        segment_rows=rows,
        total_rows=sum(rows),
        bytes_per_segment=[r * int(row_bytes) for r in rows],
        bytes_total=sum(rows) * int(row_bytes),
    )


@dataclasses.dataclass
class SegmentedIndex:
    """An append-only sequence of immutable per-batch GenieIndex segments.

    `max_count` may be left None: the first `add` resolves it through the
    engine's derived bound, and every later segment is pinned to the same
    bound so counts stay comparable across segments.  `device=None` means
    the card (and raises when there is none).
    """

    engine: Engine
    max_count: Optional[int] = None
    use_kernel: bool = True
    segments: list[GenieIndex] = dataclasses.field(default_factory=list)
    compaction_count: int = 0
    compaction_seconds: float = 0.0
    # storage format every segment is sealed into (core/packing.py)
    signature_layout: SignatureLayout = SignatureLayout.WIDE
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.signature_layout = self.model.require_layout(self.signature_layout)

    @classmethod
    def from_segments(cls, segment_data: Sequence, engine: Engine | str = Engine.EQ,
                      max_count: Optional[int] = None, use_kernel: bool = True,
                      device: DeviceLike = None,
                      signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
                      ) -> "SegmentedIndex":
        """Rebuild an index from per-segment prepared WIDE arrays (numpy or
        tensors) in global-id order -- the state another implementation's
        segments hand over, one array per sealed segment.  Each is sealed
        into `signature_layout` here (PACKED: packed on this side)."""
        index = cls(engine=Engine(engine), max_count=max_count,
                    use_kernel=use_kernel, device=device,
                    signature_layout=signature_layout)
        for data in segment_data:
            index.add(data)
        return index

    # ------------------------------------------------------------------
    @property
    def model(self) -> _engines.MatchModel:
        return _engines.get(self.engine)

    @property
    def n_objects(self) -> int:
        return sum(s.stats.n_objects for s in self.segments)

    def __len__(self) -> int:
        return self.n_objects

    @property
    def segment_rows(self) -> list[int]:
        return [s.stats.n_objects for s in self.segments]

    @property
    def stats(self) -> IndexStats:
        """Aggregate IndexStats with per-segment build/compaction accounting."""
        segs = self.segments
        return IndexStats(
            n_objects=self.n_objects,
            n_lists=segs[0].stats.n_lists if segs else 0,
            total_postings=sum(s.stats.total_postings for s in segs),
            max_list_len=max((s.stats.max_list_len for s in segs), default=0),
            bytes_device=sum(s.stats.bytes_device for s in segs),
            build_seconds=sum(s.stats.build_seconds for s in segs),
            signature_layout=self.signature_layout.value,
            bytes_signatures_wide=sum(s.stats.bytes_signatures_wide for s in segs),
            bytes_signatures_packed=sum(s.stats.bytes_signatures_packed for s in segs),
            n_segments=len(segs),
            segment_rows=self.segment_rows,
            segment_build_seconds=[s.stats.build_seconds for s in segs],
            compaction_count=self.compaction_count,
            compaction_seconds=self.compaction_seconds,
            extra={"engine": self.engine.value},
        )

    # ------------------------------------------------------------------
    # Append
    # ------------------------------------------------------------------
    def add(self, raw_data) -> GenieIndex:
        """Seal one batch into a new immutable segment: O(batch) device work,
        no re-hash or re-upload of earlier segments."""
        shape = tuple(np.shape(raw_data))
        if not shape or shape[0] == 0:
            # an empty segment would poison every later search (0-row match)
            raise ValueError(f"cannot add an empty batch (shape {shape})")
        seg = GenieIndex.build(self.engine, raw_data, max_count=self.max_count,
                               use_kernel=self.use_kernel,
                               signature_layout=self.signature_layout,
                               device=self.device)
        if self.segments:
            want = self.segments[0].data.shape[1:]
            if seg.data.shape[1:] != want:
                raise ValueError(
                    f"segment width mismatch: existing segments hold "
                    f"{tuple(want)} rows, new batch holds {tuple(seg.data.shape[1:])}"
                )
        if self.max_count is None:
            self.max_count = seg.max_count
        self.segments.append(seg)
        return seg

    # ------------------------------------------------------------------
    # Coarse routing (core/routing.py)
    # ------------------------------------------------------------------
    def router(self) -> _routing.Router:
        """A Router over the sealed segments' summaries (built at seal time,
        merged through compaction).  Raises when any segment lacks one --
        e.g. a GenieIndex assembled by hand outside build()."""
        if not self.segments:
            raise ValueError("empty SegmentedIndex: add() first")
        missing = [i for i, s in enumerate(self.segments) if s.summary is None]
        if missing:
            raise ValueError(
                f"segments {missing} carry no routing summary (assembled "
                f"outside GenieIndex.build?); routing needs per-segment "
                f"summaries"
            )
        return _routing.Router(engine=self.engine,
                               summaries=[s.summary for s in self.segments])

    def _routed_execute(self, plan, queries, routing: _routing.Routing,
                        router: _routing.Router | None = None) -> TopKResult:
        # the router scores canonical WIDE queries; the executor gets them
        # packed when the segments are PACKED
        q_wide = self.model.prepare_queries(queries, self.device)
        q_exec = q_wide
        if self.signature_layout is SignatureLayout.PACKED:
            q_exec = self.model.pack_queries(q_wide)
        if routing is _routing.Routing.NONE:
            router = None
        elif router is None:
            router = self.router()
        return _plan.execute(plan, [s.data for s in self.segments], q_exec,
                             router=router, route_queries=q_wide)

    # ------------------------------------------------------------------
    # Search: per-segment match + select, exact cap-buffer merge
    # ------------------------------------------------------------------
    def _tune_width(self) -> int:
        """Physical stored width (words / bytes when PACKED) for cache lookup."""
        return int(self.segments[0].data.shape[1])

    def search(self, queries, k: int, method: TopKMethod = TopKMethod.CPQ,
               candidate_cap: int | None = None,
               routing: _routing.Routing | str = _routing.Routing.NONE,
               nprobe: int | None = None,
               router: _routing.Router | None = None,
               tile_overrides=None, autotune=None) -> TopKResult:
        """`router` lets a caller that caches the Router across searches
        (serve/retrieval.py keys it on the corpus fingerprint) skip the
        per-search rebuild; ignored when routing is NONE.

        `autotune` consults the measured-knob cache (core/autotune.py); when
        the tuned entry prefers the MULTILOAD host loop over the SEGMENTED
        merge for this shape, the search delegates there -- both layouts
        stream the same per-part tensors and merge bit for bit identically,
        so the switch is orchestration cost only."""
        if not self.segments:
            raise ValueError("empty SegmentedIndex: add() first")
        routing = _routing.Routing(routing)
        # the spec resolved against the index's device: the cache's
        # fingerprint is checked against that device
        autotune = _autotune.resolve_cache(autotune, self.device)
        if autotune is not None:
            entry = autotune.lookup(self.engine, self.signature_layout,
                                    self.n_objects, self._tune_width())
            if entry is not None and entry.layout == "multiload_host":
                return self.search_multiload(
                    queries, k, method=method, candidate_cap=candidate_cap,
                    routing=routing, nprobe=nprobe, router=router,
                    tile_overrides=tile_overrides, autotune=autotune,
                )
        with trace.span("index.search", k=k):
            plan = _plan.plan_search(
                self.engine, k, self.max_count, layout=_plan.Layout.SEGMENTED,
                part_rows=tuple(self.segment_rows), method=method,
                candidate_cap=candidate_cap, use_kernel=self.use_kernel,
                signature_layout=self.signature_layout,
                routing=routing, nprobe=nprobe,
                tile_overrides=tile_overrides, autotune=autotune,
                tune_width=self._tune_width(),
            )
            return self._routed_execute(plan, queries, routing, router=router)

    def search_multiload(self, queries, k: int, method: TopKMethod = TopKMethod.CPQ,
                         candidate_cap: int | None = None,
                         routing: _routing.Routing | str = _routing.Routing.NONE,
                         nprobe: int | None = None,
                         router: _routing.Router | None = None,
                         tile_overrides=None, autotune=None) -> TopKResult:
        """Stream the segments through the device one at a time (paper
        section III-D's host loop) -- segments of heterogeneous sizes are the
        parts, so nothing is re-concatenated or re-padded."""
        if not self.segments:
            raise ValueError("empty SegmentedIndex: add() first")
        routing = _routing.Routing(routing)
        autotune = _autotune.resolve_cache(autotune, self.device)
        with trace.span("index.search", k=k):
            plan = _plan.plan_search(
                self.engine, k, self.max_count, layout=_plan.Layout.MULTILOAD,
                part_rows=tuple(self.segment_rows), n_objects=self.n_objects,
                method=method, candidate_cap=candidate_cap,
                use_kernel=self.use_kernel, host_loop=True,
                signature_layout=self.signature_layout,
                routing=routing, nprobe=nprobe,
                tile_overrides=tile_overrides, autotune=autotune,
                tune_width=self._tune_width(),
            )
            return self._routed_execute(plan, queries, routing, router=router)

    # ------------------------------------------------------------------
    # Compaction
    # ------------------------------------------------------------------
    def compact(self, max_segments: int = 1) -> None:
        """Coalesce adjacent segments (smallest combined pair first) until at
        most `max_segments` remain.  Global ids are preserved: neighbours
        concatenate in append order.  O(n) device copy, no re-hash."""
        if max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {max_segments}")
        if len(self.segments) <= max_segments:
            return
        segs = list(self.segments)
        t_total = 0.0
        while len(segs) > max_segments:
            sizes = [s.stats.n_objects for s in segs]
            i = min(range(len(segs) - 1), key=lambda j: sizes[j] + sizes[j + 1])
            # perf_counter, not time(): a wall-clock (NTP) step must never
            # record a negative compaction duration
            t0 = time.perf_counter()
            a, b = segs[i].stats, segs[i + 1].stats
            arr = torch.cat([segs[i].data, segs[i + 1].data], dim=0)
            synchronize(arr.device)
            t_total += time.perf_counter() - t0
            # aggregate the sources' stats instead of recomputing on `arr`:
            # every field is additive (or a max), and a PACKED `arr` holds
            # words -- build_stats would misread its width as signature
            # slots.  The merged segment keeps
            # its sources' *build* time; the concat cost is compaction
            # accounting, not build accounting.
            stats = IndexStats(
                n_objects=a.n_objects + b.n_objects,
                n_lists=a.n_lists,
                total_postings=a.total_postings + b.total_postings,
                max_list_len=max(a.max_list_len, b.max_list_len),
                bytes_device=a.bytes_device + b.bytes_device,
                build_seconds=a.build_seconds + b.build_seconds,
                signature_layout=self.signature_layout.value,
                bytes_signatures_wide=(a.bytes_signatures_wide
                                       + b.bytes_signatures_wide),
                bytes_signatures_packed=(a.bytes_signatures_packed
                                         + b.bytes_signatures_packed),
                extra={"engine": self.engine.value},
            )
            # routing summaries merge like the stats: bounds widen, sketches
            # OR, centroids row-weight -- no recompute on the (possibly
            # packed) concatenated tensor.  A hand-assembled summary-less
            # source poisons the merge to None (router() then says why).
            summary = None
            if segs[i].summary is not None and segs[i + 1].summary is not None:
                summary = _routing.merge_summaries(segs[i].summary,
                                                   segs[i + 1].summary)
            segs[i:i + 2] = [GenieIndex(engine=self.engine, max_count=self.max_count,
                                        data=arr, stats=stats,
                                        use_kernel=self.use_kernel,
                                        signature_layout=self.signature_layout,
                                        summary=summary)]
        self.segments = segs
        self.compaction_count += 1
        self.compaction_seconds += t_total

    # ------------------------------------------------------------------
    # Export for a sharded layout
    # ------------------------------------------------------------------
    def concat_data(self, pad_multiple: int = 1) -> tuple[torch.Tensor, int]:
        """(data, n_objects): segments concatenated in global-id order, row
        count padded up to a multiple of `pad_multiple` with the engine's pad
        fill.  Plan with `n_objects` so pad rows are masked out of every
        candidate buffer."""
        if not self.segments:
            raise ValueError("empty SegmentedIndex: add() first")
        data = torch.cat([s.data for s in self.segments], dim=0)
        return _plan.pad_to_multiple(
            data, pad_multiple, self.model.pad_value_for(self.signature_layout))
