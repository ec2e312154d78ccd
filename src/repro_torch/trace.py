"""Spans and counters of the search path.

A span marks one stage of a search where its work happens: `search`
(`RetrievalService.search`) and `index.search` (`SegmentedIndex.search` /
`search_multiload`), `hash`, one `part` a part of the index (attributes
`index`, `rows`, `queries` and `k`, the width of the part's buffer) with its
stages `match`, `pad_mask`, `cpq.gate`, `cpq.compact`, `cpq.order` (or
`fused_topk`, `sort_select`, `spq_select`), then `merge` and `mle`.  A span
opened while no span is open on its thread is a root: one search, whose id
every span below it shares.

Spans are off by default and cost a global read when off: `span` returns a
shared null context.  They are on while `torch.profiler` records, or after
`enable()`.  On, each span

  - enters `torch.profiler.record_function("repro_torch.<name>")` while the
    profiler records, so it lands in the profiler's trace beside the device
    operations it launched;
  - records the host's `perf_counter_ns` at open and close;
  - records its parent and its search id;
  - where CUDA is in use, records a pair of pooled timing events on the
    current stream of the current device at open and close: its
    `device_ms` is the time the stream took from one to the other, the idle
    between its operations included.

`add(name, value)` attaches a value to the innermost open span (a device
tensor too: nothing synchronises until the spans are read).  The last RING
root spans are kept with their trees; older ones are dropped and their
events reused.

An operator reads a live process with no profiler attached::

    from repro_torch import trace
    trace.enable()
    ...                                   # searches
    for s in trace.searches(8):           # the last 8, oldest first
        print(s["name"], s["device_ms"], [(c["name"], c["device_ms"])
                                          for c in s["children"]])
    trace.clear()
    trace.disable()

`searches(n)` synchronises the device once and returns plain dicts: `name`,
`id`, `search_id`, `parent` (its id, None for a root), `attrs`, `host_start_ns`,
`host_end_ns`, `device_ms` (None without CUDA), `counters` (name -> the sum
of the values added) and `children`, in the order they were opened.

Process counters are apart from spans and always on: `counter(name)` is a
dict of key -> int that a module adds to with a plain integer add (the
kernel launches of kernels/common.py, the bytes the host loop of
core/plan.py copies), each read through its module's functions;
`counters()` copies them all.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "repro_torch."
RING = 64

_NULL = contextlib.nullcontext()
_enabled = False
_ids = itertools.count(1)
_lock = threading.Lock()
_ring: collections.deque = collections.deque()      # root spans, oldest first
_events: list = []                                   # idle (open, close) event pairs
_local = threading.local()
_COUNTERS: dict[str, dict] = {}


def enable() -> None:
    """Keep spans with no profiler recording."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether spans are kept now: after `enable()`, or while
    `torch.profiler` records."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event_pair() -> tuple:
    with _lock:
        if _events:
            return _events.pop()
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "end_ns",
                 "events", "counters", "children", "_record")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.counters: dict = {}
        self.children: list = []
        self.events = self._record = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.root = self if self.parent is None else self.parent.root
        if _autograd_profiler._is_profiler_enabled:
            self._record = torch.profiler.record_function(PREFIX + self.name)
            self._record.__enter__()
        if torch.cuda.is_initialized():
            self.events = _event_pair()
            self.events[0].record()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        _stack().pop()
        if self.parent is not None:
            self.parent.children.append(self)
        else:
            _keep(self)
        return False


def span(name: str, **attrs):
    """The span `name` around a `with` block; off, a shared null context."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, attrs)


def add(name: str, value) -> None:
    """Add `value` (a number or a tensor, read when the spans are read) to
    the counter `name` of the innermost open span; nothing when spans are
    off or none is open."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    if stack:
        stack[-1].counters.setdefault(name, []).append(value)


def _walk(s: _Span):
    yield s
    for c in s.children:
        yield from _walk(c)


def _recycle(root: _Span) -> None:
    for s in _walk(root):
        if s.events is not None:
            _events.append(s.events)
            s.events = None


def _keep(root: _Span) -> None:
    with _lock:
        _ring.append(root)
        while len(_ring) > RING:
            _recycle(_ring.popleft())


def _value(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _as_dict(s: _Span) -> dict:
    return {
        "name": s.name, "id": s.id, "search_id": s.root.id,
        "parent": None if s.parent is None else s.parent.id,
        "attrs": dict(s.attrs), "host_start_ns": s.start_ns, "host_end_ns": s.end_ns,
        "device_ms": None if s.events is None else s.events[0].elapsed_time(s.events[1]),
        "counters": {k: sum(_value(v) for v in vs) for k, vs in s.counters.items()},
        "children": [_as_dict(c) for c in s.children],
    }


def searches(n: int | None = None) -> list[dict]:
    """The last `n` root spans (all that are kept when None), oldest first,
    as plain dicts (the module's docstring lists their keys)."""
    with _lock:
        roots = list(_ring)
        if n is not None:
            roots = roots[len(roots) - n:] if n > 0 else []
        if any(r.events is not None for r in roots):
            torch.cuda.synchronize()
        return [_as_dict(r) for r in roots]


def clear() -> None:
    """Drop every kept span."""
    with _lock:
        while _ring:
            _recycle(_ring.popleft())


def counter(name: str) -> dict:
    """The process counter `name`: a dict of key -> int, made at first use
    and always on."""
    return _COUNTERS.setdefault(name, {})


def counters() -> dict:
    """A copy of every process counter."""
    return {name: dict(c) for name, c in _COUNTERS.items()}
