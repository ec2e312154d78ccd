"""Async multi-tenant serving front-end with continuous batching.

The counterpart of `repro/serve/frontend.py`.  `RetrievalService` is
synchronous and single-caller; this module accepts concurrent `submit()`
calls from many callers and tenants, coalesces compatible requests into one
search (GENIE's multi-query pass: one search answers the stacked queries of
every coalesced request), and scatters per-request results back through
futures:

    fe = ServingFrontend(max_wait_us=2000)
    fe.create_tenant("acme", embed_fn=np.asarray, scheme="e2lsh")
    fe.add("acme", items, embeddings=emb)
    fut = fe.submit("acme", None, k=10, embeddings=q)   # returns immediately
    res, sims = fut.result()                            # == serial search

Coalescing is keyed by tenant x `core/plan.batch_compat_key` (engine x
layout x signature_layout x routing x method x k-bucket): requests with
equal keys stack their query rows into one dispatch, padded to a
power-of-two row bucket with copies of row 0, and each request's rows and
top-k are sliced back out.  The slice equals a serial per-request search bit
for bit because every engine's result order is total ((count desc, id asc))
and per-query independent -- a top-k result is a row-slice and k-prefix of
the batched top-k-bucket result.  The exception is routing='routed'
(unverified): its segment selection is a union over the query batch, so its
results depend on the batch by contract; 'routed_verified' is exact.

The dispatch loop runs on a thread of its own and launches on each tenant's
device (`torch.cuda.device`, so a kernel takes that device's stream).  One
dispatch copies its ids and counts to the host once, and every request gets
numpy arrays, as in the reference.

Multi-tenancy: each tenant owns its corpus (a `RetrievalService`, or any
backend with the same search surface -- `IndexService` for raw
`SegmentedIndex` tenants) while sharing one front-end and one dispatch loop;
each tenant's router cache lives in its service.  Admission control bounds
queue depth (`max_queue`, shed with a typed `Overloaded`) and batch-assembly
wait (`max_wait_us` / `max_batch`), and tenant lifecycle uses the
fault-tolerance heartbeats (runtime/fault_tolerance.py): every submit/add
beats the tenant's slot, `idle_tenants()` lists tenants whose heartbeat
expired, and `drain(tenant)` stops admission, waits for in-flight work and
releases the tenant.  `mesh=` (a `DeviceMesh`, launch/mesh.py) is the
shared mesh every tenant that `create_tenant` builds serves sharded on
(`RetrievalService(mesh=)`).  The dispatch thread runs each search's
collectives; on a mesh of several ranks every rank must then dispatch the
same batches in the same order, which coalescing by arrival time does not
promise (ROADMAP: open for a run on several cards).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import TopKMethod
from repro_torch.core import plan as plan_lib
from repro_torch.core import routing as routing_lib
from repro_torch.core.segments import SegmentedIndex
from repro_torch.core.types import TopKResult
from repro_torch.device import tensor_from
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serve.metrics import FrontendMetrics
from repro_torch.serve.retrieval import RetrievalService
from repro_torch.serve.scheduler import Overloaded, Request, RequestQueue


@dataclasses.dataclass
class IndexService:
    """Minimal front-end backend over a raw `SegmentedIndex`: pre-hashed
    signatures in, `TopKResult` out, no LSH scheme or MLE (`sims` is None).
    Gives every registered engine -- including the ones without an LSH
    scheme (RANGE/MINSUM/IP) -- a front-end tenant surface.

    `query_adapter` unstacks engines whose native query form is not a single
    array: RANGE queries are an (lo, hi) pair, so callers submit them stacked
    as [q, 2, d] with `query_adapter=lambda a: (a[:, 0, :], a[:, 1, :])` --
    coalescing concatenates the stacked form along axis 0 and the adapter
    restores the engine's form at dispatch time.  Queries may be numpy
    arrays or tensors."""

    index: SegmentedIndex
    query_adapter: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.index.device

    def add(self, items=None, embeddings=None) -> None:
        self.index.add(items if embeddings is None else embeddings)

    def resolve_queries(self, queries, embeddings=None):
        sigs = queries if embeddings is None else embeddings
        if not isinstance(sigs, torch.Tensor):
            sigs = np.asarray(sigs)
        if sigs.ndim < 2:
            raise ValueError(f"query signatures must be [q, ...], got "
                             f"shape {tuple(sigs.shape)}")
        if sigs.shape[0] == 0:
            raise ValueError("cannot search an empty batch of queries")
        return sigs

    def batch_compat_key(self, k: int, method, routing, *,
                         nprobe=None, candidate_cap=None) -> tuple:
        return plan_lib.batch_compat_key(
            self.index.engine, plan_lib.Layout.SEGMENTED,
            self.index.signature_layout, routing, method, k,
            nprobe=nprobe, candidate_cap=candidate_cap)

    def search(self, queries, k: int = 10, *, embeddings=None,
               method=TopKMethod.CPQ, candidate_cap=None,
               routing=routing_lib.Routing.NONE, nprobe=None):
        sigs = self.resolve_queries(queries, embeddings)
        if self.query_adapter is not None:
            sigs = self.query_adapter(sigs)
        res = self.index.search(sigs, k=k, method=method,
                                candidate_cap=candidate_cap,
                                routing=routing, nprobe=nprobe)
        return res, None


@dataclasses.dataclass
class _Tenant:
    """Registry entry: the backend plus its serving bookkeeping."""

    name: str
    service: Any
    slot: int                    # heartbeat slot (fault_tolerance monitor)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    draining: bool = False
    pending: int = 0             # admitted requests not yet completed


def _stack_rows(group: list[Request], pad: int):
    """The group's query rows stacked in request order, then `pad` copies of
    row 0, in one concatenation: numpy where every request sent numpy,
    otherwise tensors on the device of the first tensor."""
    rows = [r.embeddings for r in group]
    if not pad and len(rows) == 1:
        return rows[0]
    tensors = [r for r in rows if isinstance(r, torch.Tensor)]
    if not tensors:
        rows = [np.asarray(r) for r in rows]
        fill = [np.repeat(rows[0][:1], pad, axis=0)] if pad else []
        return np.concatenate(rows + fill, axis=0)
    device = tensors[0].device
    rows = [tensor_from(r).to(device) for r in rows]
    fill = [rows[0][:1].expand(pad, *rows[0].shape[1:])] if pad else []
    return torch.cat(rows + fill, dim=0)


def _on_device(service: Any):
    """The context that makes the service's device current on this thread
    (nothing to do off the card)."""
    device = getattr(service, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ServingFrontend:
    """The async serving loop: queue -> coalesce -> search -> scatter.

    Knobs (admission control / batching):
      max_queue        queued-request bound; beyond it `submit` sheds with
                       `Overloaded` instead of growing latency unboundedly.
      max_batch        stacked query rows per dispatch.
      max_wait_us      batch-assembly wait: the oldest queued request waits
                       at most this long for companions before dispatch.
      heartbeat_timeout_s / max_tenants
                       tenant-liveness monitor (runtime/fault_tolerance.py).
    """

    def __init__(self, *, mesh=None, max_queue: int = 256,
                 max_batch: int = 1024, max_wait_us: int = 2000,
                 heartbeat_timeout_s: float = 60.0, max_tenants: int = 64,
                 metrics_window: int = 2048, start: bool = True):
        if max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
        if max_wait_us < 0:
            raise ValueError(f"max_wait_us must be >= 0, got {max_wait_us}")
        self.mesh = mesh
        self._queue = RequestQueue(max_queue=max_queue, max_batch=max_batch,
                                   max_wait_s=max_wait_us * 1e-6)
        self._metrics = FrontendMetrics(window=metrics_window)
        self._hb = HeartbeatMonitor(n_hosts=max_tenants,
                                    timeout_s=heartbeat_timeout_s)
        self._tenants: dict[str, _Tenant] = {}
        self._free_slots = list(range(max_tenants))
        self._reg = threading.Condition()   # tenant registry + pending waits
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        """Start the dispatch loop (idempotent; `start=False` constructions
        call this once their tenants are registered)."""
        if self._stop.is_set():
            raise RuntimeError("frontend is closed; build a new one")
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="serving-frontend",
                                            daemon=True)
            self._thread.start()

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop admission, drain every admitted request, stop the loop.
        Raises TimeoutError when the loop outlives `timeout` seconds."""
        self._stop.set()
        self._queue.wake()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"the dispatch loop still runs after {timeout}s")
            self._thread = None

    def __enter__(self) -> "ServingFrontend":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Tenants
    # ------------------------------------------------------------------
    def register(self, name: str, service: Any) -> Any:
        """Register a tenant backend (a `RetrievalService`, `IndexService`,
        or anything with the same add/resolve_queries/batch_compat_key/
        search surface).  Returns the service for chaining."""
        for attr in ("add", "search", "resolve_queries", "batch_compat_key"):
            if not callable(getattr(service, attr, None)):
                raise TypeError(
                    f"tenant backend must provide {attr}(); "
                    f"{type(service).__name__} does not")
        with self._reg:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} is already registered")
            if not self._free_slots:
                raise Overloaded(
                    f"tenant capacity exhausted ({len(self._tenants)} "
                    f"registered, max_tenants reached): cannot register "
                    f"{name!r}", tenant=name)
            slot = self._free_slots.pop()
            self._tenants[name] = _Tenant(name=name, service=service, slot=slot)
            self._hb.beat(slot)
        return service

    def create_tenant(self, name: str, **retrieval_kwargs) -> RetrievalService:
        """Build and register a `RetrievalService` tenant on the shared mesh
        (keyword args go to the RetrievalService constructor; `device=None`
        is the mesh's device type, or the card without a mesh)."""
        return self.register(name, RetrievalService(mesh=self.mesh, **retrieval_kwargs))

    def _tenant(self, name: str, *, for_submit: bool = False) -> _Tenant:
        with self._reg:
            t = self._tenants.get(name)
            if t is None:
                raise KeyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._tenants)}")
            if for_submit and t.draining:
                raise ValueError(f"tenant {name!r} is draining: no new "
                                 f"requests admitted")
            return t

    def add(self, tenant: str, items, embeddings=None) -> None:
        """Grow a tenant's corpus.  Serialised against that tenant's
        in-flight dispatches (per-tenant lock), so a dispatch observes the
        corpus either before or after the add, never mid-mutation; the
        tenant's router cache refreshes on the next search via the corpus
        fingerprint."""
        t = self._tenant(tenant, for_submit=True)
        with t.lock:
            t.service.add(items, embeddings=embeddings)
        self._hb.beat(t.slot)

    def tenants(self) -> list[str]:
        with self._reg:
            return sorted(self._tenants)

    def idle_tenants(self, now: Optional[float] = None) -> list[str]:
        """Tenants whose heartbeat (last submit/add) expired -- candidates
        for `drain()`.  `now` is wall-clock (time.time), forwarded to the
        fault-tolerance monitor for deterministic tests."""
        with self._reg:
            dead = set(self._hb.dead(now))
            return sorted(n for n, t in self._tenants.items()
                          if t.slot in dead)

    def drain(self, tenant: str, timeout: Optional[float] = None) -> None:
        """Cleanly remove a tenant: stop admitting its requests, wait for
        its admitted work to complete, then release its slot and metrics.
        Raises TimeoutError if in-flight work outlives `timeout`."""
        t = self._tenant(tenant)
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._reg:
            t.draining = True
            while t.pending > 0:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"drain({tenant!r}): {t.pending} requests still "
                        f"in flight after {timeout}s")
                self._reg.wait(timeout=remaining)
            self._tenants.pop(tenant, None)
            self._free_slots.append(t.slot)
        self._metrics.forget_tenant(tenant)

    def reap_idle(self, now: Optional[float] = None,
                  timeout: Optional[float] = None) -> list[str]:
        """Drain every heartbeat-expired tenant; returns the drained names."""
        idle = self.idle_tenants(now)
        for name in idle:
            self.drain(name, timeout=timeout)
        return idle

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------
    def submit(self, tenant: str, queries=None, k: int = 10, *,
               embeddings=None, method: TopKMethod = TopKMethod.CPQ,
               routing: routing_lib.Routing | str = routing_lib.Routing.NONE,
               nprobe: Optional[int] = None,
               candidate_cap: Optional[int] = None) -> Future:
        """Submit one search; returns a `Future` resolving to the same
        `(TopKResult, sims)` pair `RetrievalService.search` returns, as
        numpy arrays sliced out of the coalesced dispatch.  Validation
        (unknown tenant, empty/missized query batches, draining tenants,
        queue-full `Overloaded`) happens synchronously on the caller's
        thread.  The future carries the request-order id as `.request_seq`."""
        if self._stop.is_set():
            raise RuntimeError("frontend is closed: submit rejected")
        t = self._tenant(tenant, for_submit=True)
        method = TopKMethod(method)
        routing = routing_lib.Routing(routing)
        emb = t.service.resolve_queries(queries, embeddings)
        key = (tenant, t.service.batch_compat_key(
            k, method, routing, nprobe=nprobe, candidate_cap=candidate_cap))
        dispatch_k = int(k) if candidate_cap is not None else plan_lib.k_bucket(k)
        fut: Future = Future()
        req = Request(
            seq=next(self._seq), tenant=tenant, embeddings=emb, k=int(k),
            dispatch_k=dispatch_k, method=method, routing=routing,
            nprobe=nprobe, candidate_cap=candidate_cap, key=key, future=fut,
            submitted_at=time.perf_counter(),
        )
        fut.request_seq = req.seq
        with self._reg:
            t.pending += 1
        try:
            depth = self._queue.offer(req)
        except Overloaded:
            with self._reg:
                t.pending -= 1
                self._reg.notify_all()
            self._metrics.record_shed(tenant)
            raise
        self._hb.beat(t.slot)
        self._metrics.record_submit(tenant, req.n_queries)
        self._metrics.record_queue_depth(depth)
        return fut

    def search(self, tenant: str, queries=None, k: int = 10, *,
               timeout: Optional[float] = None, **kw):
        """Synchronous convenience: `submit(...).result(timeout)`."""
        return self.submit(tenant, queries, k, **kw).result(timeout)

    def stats(self) -> dict:
        """Metrics snapshot (serve/metrics.py schema) plus registry state."""
        snap = self._metrics.snapshot()
        with self._reg:
            snap["registered_tenants"] = sorted(self._tenants)
            snap["pending_requests"] = sum(t.pending
                                           for t in self._tenants.values())
        return snap

    # ------------------------------------------------------------------
    # Dispatch loop: queue -> coalesce -> search -> scatter
    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            groups = self._queue.take(self._stop)
            if groups is None:      # stopped and fully drained
                return
            self._metrics.record_queue_depth(self._queue.depth())
            for group in groups:
                self._dispatch(group)

    def _dispatch(self, group: list[Request]) -> None:
        """One coalesced search: stack the group's query rows, run the
        tenant's search at the shared bucketed k on its device, copy ids and
        counts to the host once, slice per-request results back out, resolve
        futures.  A failure resolves every future in the group
        exceptionally; the loop itself never dies."""
        first = group[0]
        try:
            t = self._tenant(first.tenant)
            rows = sum(r.n_queries for r in group)
            # row bucketing: the stacked batch padded to the next power of
            # two with copies of row 0, sliced away below -- every engine's
            # match/select/merge is per-query independent, so real rows are
            # unaffected (the argument that makes the k-bucket slice exact)
            stacked = _stack_rows(group, plan_lib.k_bucket(rows) - rows)
            with t.lock, _on_device(t.service):
                res, sims = t.service.search(
                    None, k=first.dispatch_k, embeddings=stacked,
                    method=first.method, routing=first.routing,
                    nprobe=first.nprobe, candidate_cap=first.candidate_cap)
                # one copy to the host for the whole dispatch
                host = torch.stack([res.ids, res.counts]).cpu().numpy()
            ids, counts = host[0], host[1]
            sims_np = None if sims is None else np.asarray(sims)
            done = time.perf_counter()
            lo = 0
            for req in group:
                hi = lo + req.n_queries
                rcnt = counts[lo:hi, :req.k]
                out = TopKResult(ids=ids[lo:hi, :req.k], counts=rcnt,
                                 threshold=rcnt[:, -1])
                rsims = None if sims_np is None else sims_np[lo:hi, :req.k]
                self._metrics.record_completion(req.tenant,
                                                done - req.submitted_at)
                req.future.set_result((out, rsims))
                lo = hi
            self._metrics.record_dispatch(len(group), lo)
        # Scatter boundary: whatever a dispatch raises must resolve the
        # group's futures exceptionally -- a waiting caller would otherwise
        # hang forever.  An error leaves the loop running; an interrupt or
        # exit is passed on after the scatter.
        # genielint: ignore[broad-except]
        except BaseException as e:  # noqa: BLE001 -- scatter, then decide
            for req in group:
                if not req.future.done():
                    req.future.set_exception(e)
            if not isinstance(e, Exception):
                raise
        finally:
            with self._reg:
                for req in group:
                    tt = self._tenants.get(req.tenant)
                    if tt is not None:
                        tt.pending -= 1
                self._reg.notify_all()
