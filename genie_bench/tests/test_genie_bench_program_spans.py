"""The readers of the program's spans and counters (repro_torch.trace): each
on a canned trace beside a canned set of searches; nothing where the program
has no spans or they do not pair up with the trace's; and in a tiny traced
run of each cell on the CPU, the counter and the idle read a value while the
device times, which need CUDA, read nothing."""
import sys

import pytest
import torch

from genie_bench import run
from genie_bench.harness import cell as cell_lib
from genie_bench.harness import trace as trace_lib
from genie_bench.harness.peaks import Context
from genie_bench.tests.tiny import CELLS, one_thread, tiny_cell  # noqa: F401  (autouse)

import repro_torch  # noqa: E402  (on the path the harness sets)
from repro_torch import trace  # noqa: E402

SPAN_METRICS = ["hash.device_ms", "cpq.gate.device_ms", "cpq.compact.device_ms",
                "cpq.order.device_ms", "merge.device_ms"]
METRICS = SPAN_METRICS + ["search.idle_ms", "cpq.candidates_per_k"]


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": {}}


def A(name, ts, dur):
    return X("repro_torch." + name, "user_annotation", ts, dur)


# microseconds; the window is [1000, 2000), two requests
EVENTS = [
    X("genie_bench.window", "user_annotation", 1000, 1000),
    X("genie_bench.request", "user_annotation", 1000, 460),
    X("genie_bench.request", "user_annotation", 1500, 450),
    A("search", 600, 300),                          # before the window
    A("search", 1000, 400), A("hash", 1010, 40), A("index.search", 1050, 300),
    A("part", 1060, 200),
    A("search", 1500, 400), A("hash", 1510, 40), A("index.search", 1550, 300),
    X("void match_count_kernel(int const*)", "kernel", 1100, 200),
    X("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1400, 50),
    X("void at::native::scan_kernel<int>(int*)", "kernel", 1600, 250),
]


def S(name, device_ms=None, children=(), attrs=None, counters=None):
    return {"name": name, "device_ms": device_ms, "children": list(children),
            "attrs": attrs or {}, "counters": counters or {}}


def part(passed):
    return S("part", 31.0, [S("match", 0.0), S("pad_mask", 0.0),
                            S("cpq.gate", 2.0, counters={"cpq.passed": passed}),
                            S("cpq.compact", 30.0), S("cpq.order", 1.5)],
             attrs={"index": 0, "rows": 50, "queries": 4, "k": 2})


def search():
    return S("search", 400.0, [S("hash", 1.0),
                               S("index.search", 63.0, [part(10), part(14), S("merge", 0.5)]),
                               S("mle", 0.1)])


def ctx(events=EVENTS, requests=2) -> Context:
    return Context(cfg={}, trace=trace_lib.reduce(events), requests=requests, least_work=[],
                   own_kernels=None)


@pytest.fixture
def found(monkeypatch):
    """The program's searches, as `trace.searches` gives them."""
    out = [search(), search()]
    monkeypatch.setattr(trace, "searches", lambda n=None: out[len(out) - n:])
    return out


@pytest.mark.parametrize("name,want", [
    ("hash.device_ms", 1.0),
    ("cpq.gate.device_ms", 4.0),
    ("cpq.compact.device_ms", 60.0),
    ("cpq.order.device_ms", 3.0),
    ("merge.device_ms", 0.5),
    # idle inside the roots: [1000, 1100) + [1300, 1400), then [1500, 1600) + [1850, 1900)
    ("search.idle_ms", 0.35 / 2),
    # (10 + 14) passed a search over 2 parts of 4 queries x 2 slots
    ("cpq.candidates_per_k", 24 / 16),
])
def test_each_reader_on_a_canned_trace_and_searches(found, name, want):
    assert cell_lib.metric_reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_without_the_programs_trace_module_a_reader_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert cell_lib.metric_reader(name)(ctx()) is None


@pytest.mark.parametrize("name", METRICS)
def test_where_the_roots_do_not_pair_up_a_reader_reads_nothing(found, name):
    one_root = [e for e in EVENTS if not (e["name"] == "repro_torch.search" and e["ts"] == 1500)]
    assert cell_lib.metric_reader(name)(ctx(one_root)) is None
    assert cell_lib.metric_reader(name)(ctx(requests=3)) is None
    found[0]["name"] = "index.search"
    assert cell_lib.metric_reader(name)(ctx()) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_traced_run_reads_the_counter_and_the_idle_and_no_device_time(name):
    trace.clear()
    got = run.run_cell(tiny_cell(name), 2 ** 33 + 9, 0.3, True, torch.device("cpu"), 0.0)
    assert got["correct"]
    metrics = got["metrics"]
    assert metrics["search.idle_ms"]["value"] > 0
    assert metrics["cpq.candidates_per_k"]["value"] >= 1
    assert not set(SPAN_METRICS) & set(metrics)
    assert not trace.on()
