"""Serving-front-end metrics: per-tenant latency percentiles, batch
occupancy, coalesce ratio, queue depth.

The front-end (serve/frontend.py) is judged on exactly the numbers Johnson
et al.'s billion-scale serving work tracks -- tail latency and device
occupancy under concurrent load -- so this module records them where they
happen (submit / shed / dispatch / completion) behind one lock and exposes
a consistent snapshot through `FrontendMetrics.snapshot()`, which
`ServingFrontend.stats()` re-exports.  The counterpart of
`repro/serve/metrics.py`.

Everything here is host-side bookkeeping: a bounded per-tenant latency
window (so a long-lived serving process cannot grow without bound), plain
counters for requests/queries/sheds, and per-dispatch occupancy samples.
Percentiles use the nearest-rank method on the retained window -- cheap,
deterministic, and exact for the window it describes.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional


def percentile(samples, p: float) -> float:
    """Nearest-rank percentile of `samples` (p in [0, 100]); 0.0 on empty."""
    if not samples:
        return 0.0
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    ordered = sorted(samples)
    rank = min(len(ordered) - 1, max(0, int(round(p / 100.0 * (len(ordered) - 1)))))
    return float(ordered[rank])


@dataclasses.dataclass
class _TenantCounters:
    """One tenant's running totals plus its bounded latency window."""

    submitted: int = 0          # requests admitted to the queue
    shed: int = 0               # requests rejected by admission control
    queries: int = 0            # query rows admitted
    dispatched: int = 0         # requests that completed through a dispatch
    latencies_s: collections.deque = None  # submit -> result, bounded window

    def __post_init__(self):
        if self.latencies_s is None:
            self.latencies_s = collections.deque(maxlen=2048)


class FrontendMetrics:
    """Thread-safe recorder for the serving front-end.

    `window` bounds the retained latency samples per tenant (and the global
    occupancy window): percentiles describe the most recent `window`
    completions, not all-time history.
    """

    def __init__(self, window: int = 2048):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantCounters] = {}
        self._dispatches = 0                 # device dispatches issued
        self._dispatched_requests = 0        # requests served by them
        self._dispatched_queries = 0         # query rows served by them
        self._occupancy = collections.deque(maxlen=self.window)  # queries/dispatch
        self._queue_depth = 0
        self._queue_high_water = 0

    # -- recording hooks (called by frontend/scheduler) --------------------
    def _tenant(self, name: str) -> _TenantCounters:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _TenantCounters(
                latencies_s=collections.deque(maxlen=self.window))
        return t

    def record_submit(self, tenant: str, n_queries: int) -> None:
        with self._lock:
            t = self._tenant(tenant)
            t.submitted += 1
            t.queries += int(n_queries)

    def record_shed(self, tenant: str) -> None:
        with self._lock:
            self._tenant(tenant).shed += 1

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = int(depth)
            self._queue_high_water = max(self._queue_high_water, int(depth))

    def record_dispatch(self, n_requests: int, n_queries: int) -> None:
        """One coalesced device dispatch serving `n_requests` requests whose
        stacked query batch held `n_queries` rows."""
        with self._lock:
            self._dispatches += 1
            self._dispatched_requests += int(n_requests)
            self._dispatched_queries += int(n_queries)
            self._occupancy.append(int(n_queries))

    def record_completion(self, tenant: str, latency_s: float) -> None:
        """One request's submit -> result latency (recorded per request, so
        tenant percentiles weight requests, not dispatches)."""
        with self._lock:
            t = self._tenant(tenant)
            t.dispatched += 1
            t.latencies_s.append(float(latency_s))

    def forget_tenant(self, tenant: str) -> None:
        """Drop a drained tenant's counters (serve/frontend.py drain())."""
        with self._lock:
            self._tenants.pop(tenant, None)

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Consistent point-in-time view: global coalescing/occupancy/queue
        numbers plus per-tenant request counters and latency percentiles
        (milliseconds; 0.0 before any completion)."""
        with self._lock:
            per_tenant = {}
            all_lat: list[float] = []
            for name, t in sorted(self._tenants.items()):
                lat = list(t.latencies_s)
                all_lat.extend(lat)
                per_tenant[name] = dict(
                    submitted=t.submitted,
                    shed=t.shed,
                    queries=t.queries,
                    completed=t.dispatched,
                    p50_ms=round(percentile(lat, 50) * 1e3, 3),
                    p99_ms=round(percentile(lat, 99) * 1e3, 3),
                )
            occ = list(self._occupancy)
            return dict(
                dispatches=self._dispatches,
                requests_dispatched=self._dispatched_requests,
                queries_dispatched=self._dispatched_queries,
                # >1 means the front-end is actually coalescing: requests
                # per device dispatch
                coalesce_ratio=round(
                    self._dispatched_requests / self._dispatches, 3)
                if self._dispatches else 0.0,
                # mean stacked-query rows per dispatch over the window
                batch_occupancy=round(sum(occ) / len(occ), 3) if occ else 0.0,
                queue_depth=self._queue_depth,
                queue_high_water=self._queue_high_water,
                p50_ms=round(percentile(all_lat, 50) * 1e3, 3),
                p99_ms=round(percentile(all_lat, 99) * 1e3, 3),
                tenants=per_tenant,
            )
