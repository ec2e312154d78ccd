"""Traffic: the queries a run sends, and the loop that sends them.

A mix is `traffic/<name>.json`, a JSON object whose `loop` names its driver,
`loops/<loop>.py`; its other keys are that driver's parameters (the
driver's docstring lists them).  A new mix of a loop that is there is a data
file alone.  A driver module has

    KEYS, OPTIONAL   the keys a mix of it must have (`loop` among them), and
                     may have
    Loop(mix)        with
      warm(run)                         requests of the cell's own shapes
                                        before the window; returns the
                                        seconds one request took, warm
      requests_expected(seconds, request_s)
                                        requests a window of `seconds` sends
      window(run, seconds=None, requests=None) -> Window
                                        requests for `seconds` (the timed
                                        window) or `requests` of them (a
                                        traced window)
      close()

and names each end-to-end reading it takes in `Window.readings`.  Every mix
has `batch` (query rows a request) and `trace_requests`; it may have `k`
(answers a query), which the configuration's `k` gives otherwise.

The queries: block b of a run's query stream holds BLOCK_ROWS rows that the
reference draws from the seed (`queries`) and the system prepares as the
program takes them (`prepare`); blocks are kept on the host, pinned where
there is a card.  A request takes the next rows of the stream and carries
them to the device itself, so no row is sent twice and the device holds
only the requests in flight.  Rows are made before the window for the
requests the loop expects it to send; a window that sends more makes the
next block when it gets there, and pays for it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import re

import numpy as np
import torch

BLOCK_ROWS = 1024
COMMON_KEYS = {"loop", "batch", "trace_requests"}
_LOOP_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def loop_module(name: str):
    if not isinstance(name, str) or not _LOOP_NAME.match(name):
        raise ValueError(f"loop {name!r} is not a module name")
    return importlib.import_module(f"genie_bench.loops.{name}")


def check_mix(obj: dict) -> dict:
    """The mix `obj`, its keys checked against its loop's."""
    module = loop_module(obj.get("loop"))
    need, may = set(module.KEYS) | COMMON_KEYS, set(getattr(module, "OPTIONAL", ())) | {"k"}
    if not need <= set(obj) <= need | may:
        raise ValueError(f"a mix of loop {obj['loop']!r} has the keys {sorted(need)} "
                         f"and may have {sorted(may)}; got {sorted(obj)}")
    if min(obj["batch"], obj["trace_requests"]) < 1:
        raise ValueError(f"a mix needs a row a request and a request to trace: {obj}")
    return obj


def make_loop(mix: dict):
    return loop_module(mix["loop"]).Loop(mix)


def quantile_ms(seconds: list, q: float) -> float | None:
    """The q-quantile of `seconds`, in milliseconds (None for no values)."""
    return 1e3 * float(np.quantile(np.asarray(seconds), q)) if seconds else None


@dataclasses.dataclass
class Window:
    answers: list                  # answer dicts on the host, each with its stream "rows"
    queries: int                   # query rows sent
    seconds: float                 # the window, to the last answer back
    readings: dict                 # end-to-end readings by name
    failed: int = 0                # requests refused (shed) by the program
    missing: int = 0               # requests admitted whose answer never came


class QueryStream:
    """The run's query rows, block by block (see the module's docstring)."""

    def __init__(self, ref, cfg: dict, seed: int, inp: dict, system, device,
                 block_rows: int = BLOCK_ROWS):
        self.ref, self.cfg, self.seed, self.inp = ref, cfg, seed, inp
        self.system, self.device, self.block_rows = system, device, block_rows
        self.raw, self.ready = [], []          # host blocks: as drawn; as the program takes them
        self.taken = 0
        self.blocks_made_late = 0              # blocks made after `make` was last called
        self._pin = device.type == "cuda"

    @property
    def rows_made(self) -> int:
        return len(self.raw) * self.block_rows

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        if not self._pin:
            return x.cpu()
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x)

    def _make_blocks(self, count: int, group: int = 8) -> None:
        for first in range(len(self.raw), len(self.raw) + count, group):
            blocks = list(range(first, min(first + group, len(self.raw) + count)))
            raw = self.ref.queries(self.cfg, self.seed, self.inp, blocks, self.block_rows,
                                   self.device)
            for i in range(len(blocks)):
                part = raw[i * self.block_rows:(i + 1) * self.block_rows]
                ready = self.system.prepare(part)
                self.raw.append(self._host(part))
                self.ready.append(self.raw[-1] if ready is part else self._host(ready))
            del raw

    def make(self, rows: int) -> None:
        """Make blocks until `rows` more rows than are taken are ready."""
        want = math.ceil((self.taken + rows) / self.block_rows) - len(self.raw)
        if want > 0:
            self._make_blocks(want)
        self.blocks_made_late = 0

    def take(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The next `n` rows: (their stream indices int64 [n], the rows as the
        program takes them, on the host)."""
        end = self.taken + n
        if end > self.rows_made:
            late = math.ceil(end / self.block_rows) - len(self.raw)
            self._make_blocks(late)
            self.blocks_made_late += late
        b0, b1 = self.taken // self.block_rows, (end - 1) // self.block_rows
        lo = self.taken - b0 * self.block_rows
        if b0 == b1:
            rows = self.ready[b0][lo:lo + n]
        else:
            rows = torch.cat(self.ready[b0:b1 + 1])[lo:lo + n]
        idx = torch.arange(self.taken, end, dtype=torch.int64)
        self.taken = end
        return idx, rows

    def raw_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """The rows `idx` of the stream as drawn, on the host."""
        idx = torch.as_tensor(idx, dtype=torch.int64)
        block, within = idx // self.block_rows, idx % self.block_rows
        out = None
        for b in torch.unique(block).tolist():
            mine = (block == b).nonzero().flatten()
            part = self.raw[b][within[mine]]
            if out is None:
                out = torch.empty((idx.shape[0], *part.shape[1:]), dtype=part.dtype)
            out[mine] = part
        return out


def on_host(out: dict) -> dict:
    """An answer as the client holds it: on the host."""
    return {k: (None if v is None else torch.as_tensor(v).cpu()) for k, v in out.items()}


@dataclasses.dataclass
class Run:
    """What a loop drives: the system, its query stream, the seed, and the
    span that marks each request in a traced window."""
    system: object
    stream: QueryStream
    device: torch.device
    seed: int
    span: object = contextlib.nullcontext

    def send(self, n: int) -> dict:
        """One request of `n` rows through `system.search`: the rows carried
        to the device, the answer back on the host."""
        idx, rows = self.stream.take(n)
        with self.span():
            got = on_host(self.system.search(rows.to(self.device, non_blocking=True)))
        got["rows"] = idx
        return got
