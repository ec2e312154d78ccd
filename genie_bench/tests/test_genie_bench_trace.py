"""The trace reduction on a canned Chrome trace, the per-layer readers on
it, and queries_per_s as all the work over all the window."""
import re
import time

import pytest
import torch

from genie_bench.harness import cell as cell_lib, traffic
from genie_bench.harness import trace as trace_lib
from genie_bench.harness.peaks import Context, least_seconds
from genie_bench.tests.tiny import one_thread  # noqa: F401  (autouse)


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


# microseconds; the window is [1000, 2000)
EVENTS = [
    {"ph": "M", "name": "process_name", "args": {}},
    X("genie_bench.window", "user_annotation", 1000, 1000),
    X("genie_bench.window", "gpu_user_annotation", 1000, 1000),
    X("genie_bench.request", "user_annotation", 1000, 1000),
    X("aten::foo", "cpu_op", 1000, 600),
    X("cudaStreamSynchronize", "cuda_runtime", 1600, 100),
    X("void match_count_kernel<Shape<16, 8, 2> >(int const*)", "kernel", 1100, 200),
    X("void at::native::scan_kernel<int>(int*)", "kernel", 1250, 200),
    X("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1500, 50),
    X("void at::native::scan_kernel<int>(int*)", "kernel", 1950, 100),   # runs past the end
    X("void at::native::scan_kernel<int>(int*)", "kernel", 2500, 100),   # outside
    X("aten::bar", "cpu_op", 2500, 100),
]
OWN = re.compile(r"\b(?:match_count_kernel|cpq_hist_kernel)\b")


def canned() -> trace_lib.Trace:
    return trace_lib.reduce(EVENTS)


def test_busy_is_the_union_of_device_operations_inside_the_window():
    tr = canned()
    assert tr.window_s == pytest.approx(1e-3)
    # [1100, 1450) + [1500, 1550) + [1950, 2000)
    assert tr.busy_s == pytest.approx(450e-6)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    gaps = canned().idle_gaps()
    assert gaps == pytest.approx({"aten::foo": 150e-6, "genie_bench.request": 400e-6})


def test_kernel_seconds_by_name():
    tr = canned()
    assert tr.kernel_seconds(OWN) == pytest.approx(200e-6)
    assert tr.kernel_seconds(OWN, inside=False) == pytest.approx(250e-6)


def test_breakdown_lists_the_largest_first():
    b = canned().breakdown()
    assert [n for n, _ in b["device_ops"]][:2] == [
        "void at::native::scan_kernel<int>(int*)",
        "void match_count_kernel<Shape<16, 8, 2> >(int const*)"]
    assert b["device_ops"][0][1] == pytest.approx(250e-6)
    assert b["idle_gaps"][0][0] == "genie_bench.request"


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace_lib.reduce([e for e in EVENTS if e["name"] != "genie_bench.window"])


def _ctx(**kw) -> Context:
    work = {"match": {"ops": 67e6, "bytes": 0}, "search": {"ops": 0, "bytes": 335e6}}
    args = dict(cfg={"count_kernels": ["match_count_kernel"]}, trace=canned(), requests=2,
                least_work=[work, work], own_kernels=OWN)
    args.update(kw)
    return Context(**args)


@pytest.mark.parametrize("name,want", [
    ("search.roofline_pct", 100 * 100e-6 / 500e-6),     # 0.1 ms least of 0.5 ms a request
    ("match.device_ms", 0.1),
    ("match.roofline_pct", 100 * 1e-6 / 100e-6),        # 1 us least of 0.1 ms
    ("plain_ops.device_ms", 0.125),
    ("device.idle_pct", 55.0),
])
def test_each_reader_on_the_canned_trace(name, want):
    assert cell_lib.metric_reader(name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["match.device_ms", "match.roofline_pct"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    ctx = _ctx(cfg={"count_kernels": ["minsum_count_kernel"]})
    assert cell_lib.metric_reader(name)(ctx) is None


def test_least_seconds_of_a_context_averages_the_requests():
    ctx = _ctx(least_work=[{"search": {"ops": 67e12, "bytes": 0}},
                           {"search": {"ops": 0, "bytes": 3 * 3.35e12}}])
    assert ctx.least_seconds("search") == pytest.approx(2.0)
    assert least_seconds({"ops": 0, "bytes": 0}) == 0


class SlowSystem:
    """A system whose every request takes `seconds` on the host."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def prepare(self, rows):
        return rows

    def search(self, batch):
        time.sleep(self.seconds)
        n = batch.shape[0]
        return {"ids": torch.zeros(n, 2, dtype=torch.int32), "counts": torch.zeros(n, 2),
                "threshold": torch.zeros(n), "sims": None}


class BlockRef:
    """Query block b: rows of the value b."""

    @staticmethod
    def queries(cfg, seed, inp, blocks, rows, device):
        return torch.cat([torch.full((rows, 3), float(b)) for b in blocks])


def slow_run(seconds: float, block_rows: int = 4) -> traffic.Run:
    system, cpu = SlowSystem(seconds), torch.device("cpu")
    stream = traffic.QueryStream(BlockRef, {}, 1, {}, system, cpu, block_rows=block_rows)
    return traffic.Run(system, stream, cpu, 1)


def test_queries_per_s_is_all_the_queries_over_all_the_window():
    run = slow_run(0.03)
    loop = traffic.make_loop({"loop": "closed", "batch": 4, "warm_requests": 1,
                              "trace_requests": 1})
    t0 = time.perf_counter()
    win = loop.window(run, seconds=0.1)
    wall = time.perf_counter() - t0
    n = len(win.answers)
    # every request sent is counted, the one that crosses 0.1 s in full
    assert n >= 3 and win.queries == 4 * n
    assert max(0.1, 0.03 * n) <= win.seconds <= wall
    assert win.readings["queries_per_s"] == pytest.approx(win.queries / win.seconds)
    assert win.readings["requests_per_s"] == pytest.approx(n / win.seconds)
    # each request takes the next rows of the stream: none is sent twice
    assert torch.equal(torch.cat([a["rows"] for a in win.answers]), torch.arange(4 * n))
