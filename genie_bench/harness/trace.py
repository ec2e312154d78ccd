"""The traced run: `torch.profiler` over a few requests, and the reduction of
its Chrome trace to what the per-layer readers and the result line need.

The traced window is the span `WINDOW` that the harness opens around the
profiled requests, each of a closed loop inside a span `REQUEST` (spans of
the benchmark's own, around the calls into the program).  A device operation is a kernel, a
memcpy or a memset; the device is busy where one runs (their union), idle
elsewhere in the window.  An idle gap is named by what the host was doing at
its middle: the innermost profiled host event (an operator, a span, a
runtime call) that covers it.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import re
import tempfile
from pathlib import Path

import torch

WINDOW = "genie_bench.window"
REQUEST = "genie_bench.request"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
NO_HOST_EVENT = "host (no profiled event)"
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    start: float                   # seconds
    end: float


@dataclasses.dataclass
class Trace:
    start: float
    end: float
    device: list                   # Op, clipped to the window
    host: list                     # Op

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list:
        merged = []
        for op in sorted(self.device, key=lambda o: o.start):
            if merged and op.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], op.end)
            else:
                merged.append([op.start, op.end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, names: re.Pattern, inside: bool = True) -> float:
        """Seconds of the kernels whose name matches `names` (or, with
        `inside=False`, of those whose name does not)."""
        return sum(op.end - op.start for op in self.device
                   if op.cat == "kernel" and bool(names.search(op.name)) == inside)

    def idle_gaps(self) -> dict:
        """Idle seconds by what the host was doing."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        # by start, the longer first among equal starts, so that an event
        # inside another lies above it on the stack below
        host = sorted(self.host, key=lambda o: (o.start, -o.end))
        starts = [o.start for o in host]
        out = collections.Counter()
        stack, pushed = [], 0
        for s, e in gaps:
            mid = (s + e) / 2
            # events that started by `mid`, latest on top; one that ended
            # before `mid` ends before every later gap too
            upto = bisect.bisect_right(starts, mid)
            stack.extend(host[pushed:upto])
            pushed = max(pushed, upto)
            while stack and stack[-1].end < mid:
                stack.pop()
            out[stack[-1].name if stack else NO_HOST_EVENT] += e - s
        return dict(out)

    def breakdown(self) -> dict:
        by_op = collections.Counter()
        for op in self.device:
            by_op[op.name[:NAME_CHARS]] += op.end - op.start
        gaps = collections.Counter({k[:NAME_CHARS]: v for k, v in self.idle_gaps().items()})
        return {"device_ops": [[n, s] for n, s in by_op.most_common(BREAKDOWN_ENTRIES)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(BREAKDOWN_ENTRIES)]}


def reduce(events: list) -> Trace:
    """The Trace of a Chrome trace's events (microseconds) inside WINDOW."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"expected one {WINDOW!r} span in the trace, found {len(spans)}")
    start = spans[0]["ts"] * 1e-6
    end = start + spans[0]["dur"] * 1e-6
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = e["ts"] * 1e-6
        op = Op(name=e["name"], cat=e.get("cat", ""), start=s, end=s + e["dur"] * 1e-6)
        if op.cat in DEVICE_CATS and op.end > start and op.start < end:
            op.start, op.end = max(op.start, start), min(op.end, end)
            device.append(op)
        elif op.cat in HOST_CATS and op.name != WINDOW:
            host.append(op)
    return Trace(start=start, end=end, device=device, host=host)


def request_span():
    """The span that marks one request of a traced window."""
    from torch.profiler import record_function

    return record_function(REQUEST)


def profile(first, window):
    """Profile `first()` outside the traced window (the profiler's first
    calls are slow) and `window()` inside it.  Returns the window's Trace
    and what `window()` returned."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        first()
        with record_function(WINDOW):
            got = window()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return reduce(events), got
