"""open: requests arrive as a Poisson process at a fixed rate, drawn from the
seed, and go through the program's serving front-end (`ServingFrontend`),
which coalesces them into dispatches; each request is timed from when it
was due to when its answer was back on the host.

Mix keys: `rate` (requests offered a second), `batch` (query rows a
request), `max_batch`, `max_wait_us`, `max_queue` (the front-end's knobs),
`trace_requests` (arrivals in a traced window); at will `k`, and `drain_s`
(how long past the window the answers are waited for; 60).

Warm-up: one request of each row count a dispatch can take (the powers of
two up to `max_batch`), through the front-end.

Readings: `request_p50_ms`, `request_p95_ms`, `request_p99_ms` over every
request answered; `queries_per_s` and `requests_per_s` answered over the
window (the span of the arrivals, or to the last answer where that is
later); `shed_pct`, the share of requests the front-end refused;
`late_p95_ms`, how late the generator offered a request; the medians of the
first and the last quarter of the arrivals, `p50_first_quarter_ms` and
`p50_last_quarter_ms` (a backlog that grows shows as a rising median);
`rows_per_dispatch`.  A system offers the front-end its backend by
`backend()`.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from genie_bench.harness.seeds import derive
from genie_bench.harness.traffic import Window, quantile_ms

KEYS = {"loop", "rate", "batch", "max_batch", "max_wait_us", "max_queue", "trace_requests"}
OPTIONAL = {"drain_s"}
TENANT = "cell"


class Loop:
    def __init__(self, mix: dict):
        self.mix = mix
        self.frontend = None
        self.windows = 0

    def _start(self, run) -> None:
        from repro_torch.serve import ServingFrontend

        self.frontend = ServingFrontend(max_batch=self.mix["max_batch"],
                                        max_wait_us=self.mix["max_wait_us"],
                                        max_queue=self.mix["max_queue"])
        self.frontend.register(TENANT, run.system.backend())

    def _submit(self, run, rows):
        return self.frontend.submit(TENANT, None, k=run.system.k, embeddings=rows.numpy())

    def warm(self, run) -> float:
        if self.frontend is None:
            self._start(run)
        took, q = 0.0, 1
        while q <= self.mix["max_batch"]:
            _, rows = run.stream.take(q)
            t = time.perf_counter()
            self._submit(run, rows).result()
            took = time.perf_counter() - t
            q *= 2
        return took

    def requests_expected(self, seconds: float, request_s: float) -> int:
        return math.ceil(1.2 * self.mix["rate"] * seconds) + 16

    def _arrivals(self, seed: int, seconds: float | None, requests: int | None) -> np.ndarray:
        rng = np.random.default_rng(derive(seed, "arrivals", self.windows))
        self.windows += 1
        rate = float(self.mix["rate"])
        n = requests if requests is not None else math.ceil(1.5 * rate * seconds) + 16
        due = np.cumsum(rng.exponential(1.0 / rate, size=n))
        return due if seconds is None else due[due < seconds]

    def window(self, run, seconds: float | None = None, requests: int | None = None) -> Window:
        from repro_torch.serve.scheduler import Overloaded

        if self.frontend is None:
            self._start(run)
        due = self._arrivals(run.seed, seconds, requests)
        n, batch, k = due.shape[0], self.mix["batch"], run.system.k
        # the answers land in arrays as they come, so the window keeps no
        # object a request: objects that outlive their request would grow the
        # collector's oldest generation and bring full collections (on an
        # H100 host: 235-297 ms each, four in a 20 s window at 920 requests a
        # second) that the program's own work does not cause
        ids = np.full((n, batch, k), -1, dtype=np.int64)
        counts = np.zeros((n, batch, k), dtype=np.int64)
        threshold = np.zeros((n, batch), dtype=np.int64)
        sims = np.zeros((n, batch, k), dtype=np.float64)
        with_sims = np.zeros(n, dtype=bool)
        answered = np.zeros(n, dtype=bool)
        latency = np.full(n, np.nan)
        late = np.zeros(n)
        first_row = np.full(n, -1, dtype=np.int64)
        shed = 0
        ended = threading.Semaphore(0)

        def finished(f, i, at):
            latency[i] = time.perf_counter() - at
            if f.exception() is None:
                res, got = f.result()
                ids[i], counts[i], threshold[i] = res.ids, res.counts, res.threshold
                if got is not None:
                    sims[i], with_sims[i] = got, True
                answered[i] = True
            ended.release()

        before = self.frontend.stats()
        t0 = time.perf_counter()
        for i in range(n):
            at = t0 + float(due[i])
            wait = at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = max(0.0, -wait)
            idx, rows = run.stream.take(batch)
            first_row[i] = int(idx[0])
            try:
                fut = self._submit(run, rows)
            except Overloaded:
                shed += 1
                ended.release()
                continue
            fut.add_done_callback(lambda f, i=i, at=at: finished(f, i, at))
        deadline = time.perf_counter() + self.mix.get("drain_s", 60.0)
        for _ in range(n):
            if not ended.acquire(timeout=max(0.0, deadline - time.perf_counter())):
                break
        last = float(np.max((due + latency)[answered])) if answered.any() else 0.0
        elapsed = max(float(due[-1]) if n else 0.0, last)
        after = self.frontend.stats()
        answers = [{"rows": torch.arange(first_row[i], first_row[i] + batch),
                    "ids": torch.from_numpy(ids[i]), "counts": torch.from_numpy(counts[i]),
                    "threshold": torch.from_numpy(threshold[i]),
                    "sims": torch.from_numpy(sims[i]) if with_sims[i] else None}
                   for i in np.flatnonzero(answered)]
        times = latency[answered].tolist()
        quarter = max(1, n // 4)
        first = [x for x in latency[:quarter].tolist() if x == x]
        final = [x for x in latency[-quarter:].tolist() if x == x]
        dispatches = after["dispatches"] - before["dispatches"]
        rows_sent = after["queries_dispatched"] - before["queries_dispatched"]
        queries = batch * len(answers)
        return Window(answers=answers, queries=batch * n, seconds=elapsed, failed=shed,
                      missing=n - shed - len(answers), readings={
                          "request_p50_ms": quantile_ms(times, 0.5),
                          "request_p95_ms": quantile_ms(times, 0.95),
                          "request_p99_ms": quantile_ms(times, 0.99),
                          "queries_per_s": queries / elapsed if elapsed > 0 else None,
                          "requests_per_s": len(answers) / elapsed if elapsed > 0 else None,
                          "shed_pct": 100.0 * shed / max(1, n),
                          "late_p95_ms": quantile_ms(late.tolist(), 0.95),
                          "p50_first_quarter_ms": quantile_ms(first, 0.5),
                          "p50_last_quarter_ms": quantile_ms(final, 0.5),
                          "rows_per_dispatch": rows_sent / dispatches if dispatches else None})

    def close(self) -> None:
        if self.frontend is not None:
            self.frontend.close()
            self.frontend = None
