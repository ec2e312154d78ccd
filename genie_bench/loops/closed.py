"""closed: one client sends the next request as soon as the answer to the
last one is back on the host.

Mix keys: `batch` (query rows a request), `warm_requests` (requests of that
shape before the window), `trace_requests` (requests in a traced window);
`k` at will.

Readings: `queries_per_s`, all query rows answered over all of the window,
which ends when the last request sent is back (every request sent counts,
with all its time); `requests_per_s` likewise; `request_p50_ms` and
`request_p95_ms` over every request of the window.
"""
from __future__ import annotations

import math
import time

from genie_bench.harness.traffic import Window, quantile_ms

KEYS = {"loop", "batch", "warm_requests", "trace_requests"}
# requests made ready before the window, over those the warm-up's pace expects
MARGIN = 1.25


class Loop:
    def __init__(self, mix: dict):
        self.mix = mix

    def warm(self, run) -> float:
        took = 0.0
        for _ in range(self.mix["warm_requests"]):
            t = time.perf_counter()
            run.send(self.mix["batch"])
            took = time.perf_counter() - t
        return took

    def requests_expected(self, seconds: float, request_s: float) -> int:
        return math.ceil(MARGIN * seconds / max(request_s, 1e-4)) + 2

    def window(self, run, seconds: float | None = None, requests: int | None = None) -> Window:
        answers, took = [], []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            answers.append(run.send(self.mix["batch"]))
            now = time.perf_counter()
            took.append(now - t)
            if (requests is not None and len(answers) >= requests) or \
                    (seconds is not None and now - t0 >= seconds):
                break
        elapsed = now - t0
        queries = sum(a["rows"].numel() for a in answers)
        return Window(answers=answers, queries=queries, seconds=elapsed, readings={
            "queries_per_s": queries / elapsed, "requests_per_s": len(answers) / elapsed,
            "request_p50_ms": quantile_ms(took, 0.5), "request_p95_ms": quantile_ms(took, 0.95)})

    def close(self) -> None:
        pass
