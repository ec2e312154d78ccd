"""Continuous-batching scheduler: the queue/admission/coalescing policy of
the serving front-end (serve/frontend.py).

GENIE's device-side strength is the multi-query pass -- one inverted-index
scan answers a whole query batch (PAPER.md's multi-query processing) -- so
the serving problem is entirely host-side: accept concurrent requests from
many callers, hold them just long enough to assemble a fat batch, and hand
compatible requests to one device dispatch.  This module owns that policy,
deterministically and without touching the device:

  * `Request` -- one submitted search: resolved query embeddings, the
    request-order id (`seq`), the per-request top-k, and the coalescing key
    (tenant x `core/plan.batch_compat_key`).  Its `future` resolves to the
    per-request result.
  * `RequestQueue.offer` -- admission control: a bounded queue that sheds
    load with a typed `Overloaded` error instead of queueing unboundedly
    (the caller sees backpressure immediately; the device never does).
  * `RequestQueue.take` -- batch assembly: blocks for the first request,
    then waits at most `max_wait_s` (measured from the *oldest* queued
    request, so no request's assembly wait exceeds the knob) or until
    `max_batch` query rows are queued, drains everything, and groups it.
  * `coalesce` -- groups drained requests by coalescing key in arrival
    order and chunks each group so one dispatch never stacks more than
    `max_batch` query rows (a single oversized request still dispatches
    alone -- requests are never split across dispatches).

The scheduler never inspects engines or plans; compatibility is entirely
encoded in the key the front-end computed at submit time.  The counterpart
of `repro/serve/scheduler.py`; it holds no tensor of its own.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional


class Overloaded(RuntimeError):
    """Load shed by admission control: the request was rejected, not queued.

    Carries the shedding context so callers (and tests) can tell which
    bound tripped without parsing the message."""

    def __init__(self, message: str, *, tenant: Optional[str] = None,
                 queue_depth: Optional[int] = None,
                 max_queue: Optional[int] = None):
        super().__init__(message)
        self.tenant = tenant
        self.queue_depth = queue_depth
        self.max_queue = max_queue


@dataclasses.dataclass
class Request:
    """One submitted search, resolved and validated at submit time."""

    seq: int                      # request-order id (global, monotonic)
    tenant: str
    embeddings: Any               # resolved query rows [q, ...]
    k: int                        # the caller's top-k (result width)
    dispatch_k: int               # the bucketed k the dispatch runs at
    method: Any
    routing: Any
    nprobe: Optional[int]
    candidate_cap: Optional[int]
    key: tuple                    # (tenant, batch_compat_key) coalescing key
    future: Future
    submitted_at: float           # perf_counter at admission

    @property
    def n_queries(self) -> int:
        return int(self.embeddings.shape[0])


def coalesce(requests: list[Request], max_batch: int) -> list[list[Request]]:
    """Group drained requests by coalescing key, preserving arrival order
    within and across groups (groups are ordered by their oldest member).
    Each group is chunked so its stacked query rows stay <= `max_batch`;
    a single request larger than `max_batch` dispatches alone."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    by_key: dict[tuple, list[Request]] = {}
    for req in sorted(requests, key=lambda r: r.seq):
        by_key.setdefault(req.key, []).append(req)
    groups: list[list[Request]] = []
    for members in by_key.values():
        chunk: list[Request] = []
        rows = 0
        for req in members:
            if chunk and rows + req.n_queries > max_batch:
                groups.append(chunk)
                chunk, rows = [], 0
            chunk.append(req)
            rows += req.n_queries
        if chunk:
            groups.append(chunk)
    groups.sort(key=lambda g: g[0].seq)
    return groups


class RequestQueue:
    """Bounded, condition-guarded request queue with batch-assembly waits.

    `max_queue` bounds *requests* queued (admission), `max_batch` bounds
    *query rows* per dispatch (coalescing), `max_wait_s` bounds how long the
    oldest queued request waits for companions before dispatch."""

    def __init__(self, max_queue: int = 256, max_batch: int = 1024,
                 max_wait_s: float = 0.002):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._cond = threading.Condition()
        self._q: list[Request] = []

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def offer(self, req: Request) -> int:
        """Admit a request or shed it with `Overloaded`.  Returns the queue
        depth after admission (for the metrics gauge)."""
        with self._cond:
            if len(self._q) >= self.max_queue:
                raise Overloaded(
                    f"serving queue full ({len(self._q)}/{self.max_queue} "
                    f"requests): request for tenant {req.tenant!r} shed",
                    tenant=req.tenant, queue_depth=len(self._q),
                    max_queue=self.max_queue,
                )
            self._q.append(req)
            depth = len(self._q)
            self._cond.notify_all()
        return depth

    def wake(self) -> None:
        """Nudge a blocked `take` (used by frontend shutdown)."""
        with self._cond:
            self._cond.notify_all()

    def take(self, stop: threading.Event) -> Optional[list[list[Request]]]:
        """Block for work, assemble a batch, drain, and coalesce.

        Returns the coalesced groups, or None when `stop` is set and the
        queue is fully drained (the dispatch loop's exit signal).  When
        `stop` is set with requests still queued they are returned for a
        final graceful drain -- shutdown never abandons admitted work."""
        with self._cond:
            while not self._q:
                if stop.is_set():
                    return None
                self._cond.wait(timeout=0.05)
            if not stop.is_set() and self.max_wait_s > 0:
                deadline = self._q[0].submitted_at + self.max_wait_s
                while (sum(r.n_queries for r in self._q) < self.max_batch
                       and not stop.is_set()):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            drained = self._q
            self._q = []
        return coalesce(drained, self.max_batch)
