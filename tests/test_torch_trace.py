"""repro_torch.trace: spans off by default and free of the profiler there,
on under torch.profiler (named and nested in its trace) or after enable();
one search id a search; the ring of the last RING roots; counters attached
unread; device time from pooled event pairs; the span tree of an E2LSH and
a MINSUM search; the gate's `cpq.passed` against a brute-force count; and
the process counters that kernels/common.py and core/plan.py keep there."""
import json
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core import Engine, SegmentedIndex, TopKMethod
from repro_torch.core import cpq
from repro_torch.core import plan as plan_lib
from repro_torch.core.types import SearchParams
from repro_torch.kernels import common
from repro_torch.serve import RetrievalService

PARTS, ROWS, Q = 3, 200, 5
STAGES = ["match", "pad_mask", "cpq.gate", "cpq.compact", "cpq.order"]


@pytest.fixture(autouse=True)
def fresh():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def sift_service() -> tuple:
    gen = torch.Generator().manual_seed(0)
    svc = RetrievalService(scheme="e2lsh", m_override=16, n_buckets=67, max_segments=8,
                           device="cpu")
    for s in range(PARTS):
        svc.add(range(s * ROWS, (s + 1) * ROWS), embeddings=torch.randn(ROWS, 8, generator=gen))
    return svc, torch.randn(Q, 8, generator=gen)


def minsum_index() -> tuple:
    gen = torch.Generator().manual_seed(1)
    index = SegmentedIndex(Engine.MINSUM, max_count=127, device="cpu")
    for _ in range(PARTS):
        index.add(torch.randint(0, 4, (ROWS, 32), generator=gen, dtype=torch.int32))
    return index, torch.randint(0, 4, (Q, 32), generator=gen, dtype=torch.int32)


def sift_search(k: int = 4):
    svc, q = sift_service()
    return lambda: svc.search(None, k=k, embeddings=q)


def walk(s: dict):
    yield s
    for c in s["children"]:
        yield from walk(c)


class FakeEvent:
    """A CUDA timing event on the CPU: `elapsed_time` is the number of event
    records from this one to `end`."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = len(RECORDS)
        RECORDS.append(self)

    def elapsed_time(self, end):
        return float(end.t - self.t)


RECORDS: list = []


def test_off_by_default_a_search_enters_no_record_function_and_keeps_nothing(monkeypatch):
    entered, made = [], []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: entered.append(a))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: made.append(a))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    search = sift_search()
    assert not trace.on()
    search()
    index, q = minsum_index()
    index.search(q, k=4)
    assert entered == [] and made == [] and trace.searches() == []
    assert trace.span("search", k=4) is trace.span("part")      # the one null context


def test_under_the_profiler_the_spans_are_named_and_nested_in_its_trace(tmp_path):
    search = sift_search()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        search()
    assert not trace.on()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith(trace.PREFIX)]
    names = [e["name"][len(trace.PREFIX):] for e in events]
    assert sorted(set(names)) == sorted({"search", "hash", "index.search", "part", "merge",
                                         "mle", *STAGES})
    assert names.count("part") == PARTS and names.count("cpq.gate") == PARTS

    def inside(child, parent):
        return [e for e in events if e["name"] == trace.PREFIX + child
                and not any(p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                            for p in events if p["name"] == trace.PREFIX + parent)]

    for child, parent in [("hash", "search"), ("index.search", "search"), ("mle", "search"),
                          ("part", "index.search"), ("merge", "index.search")] + \
            [(stage, "part") for stage in STAGES]:
        assert inside(child, parent) == [], (child, parent)
    (root,) = trace.searches()
    assert root["name"] == "search" and root["device_ms"] is None


def test_the_spans_of_one_search_share_its_id_and_index_search_is_a_child():
    search = sift_search()
    trace.enable()
    search()
    search()
    first, second = trace.searches()
    assert first["search_id"] != second["search_id"]
    for root in (first, second):
        assert root["name"] == "search" and root["parent"] is None
        assert root["search_id"] == root["id"]
        assert {s["search_id"] for s in walk(root)} == {root["id"]}
        index = [c for c in root["children"] if c["name"] == "index.search"]
        assert len(index) == 1 and index[0]["parent"] == root["id"]
        assert root["host_start_ns"] <= index[0]["host_start_ns"] <= index[0]["host_end_ns"] \
            <= root["host_end_ns"]


def test_the_ring_keeps_the_last_roots():
    trace.enable()
    for i in range(trace.RING + 6):
        with trace.span("search", i=i):
            with trace.span("part"):
                pass
    kept = trace.searches()
    assert len(kept) == trace.RING
    assert [s["attrs"]["i"] for s in kept] == list(range(6, trace.RING + 6))
    assert [s["attrs"]["i"] for s in trace.searches(3)] == [trace.RING + 3, trace.RING + 4,
                                                             trace.RING + 5]
    assert trace.searches(0) == []
    trace.clear()
    assert trace.searches() == []


def test_a_span_closed_by_an_exception_is_kept_and_the_next_span_is_a_root():
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("search"):
            with trace.span("part"):
                raise ValueError("in a part")
    with trace.span("index.search"):
        pass
    first, second = trace.searches()
    assert [c["name"] for c in first["children"]] == ["part"]
    assert second["name"] == "index.search" and second["parent"] is None


def test_threads_keep_their_own_trees_in_one_ring():
    """More threads than cores, switching often: each root keeps exactly its
    own thread's children, and the ring holds the last RING roots."""
    def work(t):
        for i in range(60):
            with trace.span("search", thread=t, i=i):
                for j in range(3):
                    with trace.span("part", thread=t, j=j):
                        pass

    trace.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    kept = trace.searches()
    assert len(kept) == trace.RING
    for root in kept:
        assert [(c["attrs"]["thread"], c["attrs"]["j"]) for c in root["children"]] == \
            [(root["attrs"]["thread"], j) for j in range(3)]
        assert {c["search_id"] for c in root["children"]} == {root["id"]}


def test_add_attaches_a_tensor_unread_until_the_spans_are_read(monkeypatch):
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda t: reads.append(t) or item(t))
    trace.add("n", torch.tensor(9))                 # off: nothing
    trace.enable()
    trace.add("n", torch.tensor(9))                 # no span open: nothing
    with trace.span("search"):
        with trace.span("cpq.gate"):
            trace.add("n", torch.tensor(3))
            trace.add("n", 2)
    assert reads == []
    (root,) = trace.searches()
    assert root["counters"] == {} and root["children"][0]["counters"] == {"n": 5}
    assert len(reads) == 1


def test_device_time_comes_from_pooled_event_pairs_read_after_one_synchronize(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(a))
    FakeEvent.made = 0
    trace.enable()
    with trace.span("search"):
        with trace.span("part"):
            pass
    (root,) = trace.searches()
    # records: search open, part open, part close, search close
    assert root["device_ms"] == 3.0 and root["children"][0]["device_ms"] == 1.0
    assert len(synced) == 1
    for _ in range(3 * trace.RING):
        with trace.span("search"):
            pass
    # the pair of every root the ring dropped is used again
    assert FakeEvent.made == 2 * (trace.RING + 2)


def test_an_e2lsh_search_makes_the_span_tree_of_its_stages():
    k = 4
    search = sift_search(k)
    trace.enable()
    search()
    (root,) = trace.searches()
    assert root["name"] == "search" and root["attrs"] == {"k": k}
    assert [c["name"] for c in root["children"]] == ["hash", "index.search", "mle"]
    index = root["children"][1]
    assert [c["name"] for c in index["children"]] == ["part"] * PARTS + ["merge"]
    for i, part in enumerate(index["children"][:PARTS]):
        assert part["attrs"] == {"index": i, "rows": ROWS, "queries": Q, "k": k}
        assert [c["name"] for c in part["children"]] == STAGES
        assert set(part["children"][2]["counters"]) == {"cpq.passed"}


def test_a_minsum_search_is_a_root_of_its_own():
    index, q = minsum_index()
    trace.enable()
    index.search(q, k=4)
    index.search_multiload(q, k=4)
    for root in trace.searches():
        assert root["name"] == "index.search" and root["attrs"] == {"k": 4}
        assert [c["name"] for c in root["children"]] == ["part"] * PARTS + ["merge"]
        assert all([c["name"] for c in p["children"]] == STAGES
                   for p in root["children"][:PARTS])


@pytest.mark.parametrize("method,stage", [(TopKMethod.SORT, "sort_select"),
                                          (TopKMethod.SPQ, "spq_select")])
def test_the_other_selections_are_one_span_each(method, stage):
    index, q = minsum_index()
    trace.enable()
    index.search(q, k=4, method=method)
    (root,) = trace.searches()
    for part in root["children"][:PARTS]:
        assert [c["name"] for c in part["children"]] == ["match", "pad_mask", stage]


@pytest.mark.parametrize("layout", ["monolithic", "scan"])
def test_the_single_pass_layouts_have_a_part_span_a_part(layout):
    gen = torch.Generator().manual_seed(2)
    data = torch.randint(0, 5, (4 * 50, 12), generator=gen, dtype=torch.int32)
    queries = data[:Q].clone()
    if layout == "monolithic":
        plan = plan_lib.plan_search(Engine.EQ, 3, 12, use_kernel=False)
    else:
        plan = plan_lib.plan_search(Engine.EQ, 3, 12, layout=plan_lib.Layout.MULTILOAD,
                                    n_parts=4, n_objects=200, use_kernel=False)
        data = plan_lib.pad_and_stack(plan, data)
    trace.enable()
    with trace.span("search"):
        plan_lib.execute(plan, data, queries)
    names = [c["name"] for c in trace.searches()[0]["children"]]
    assert names == (["part"] if layout == "monolithic" else ["part", "merge"] * 4)


@pytest.mark.parametrize("k,max_count", [(1, 6), (10, 6), (40, 3), (300, 6)])
def test_cpq_passed_is_the_count_of_objects_at_or_above_the_threshold(k, max_count):
    gen = torch.Generator().manual_seed(k)
    counts = torch.randint(0, max_count + 1, (7, 257), generator=gen, dtype=torch.int32)
    counts[0] = 0                                  # a row whose threshold is 0
    trace.enable()
    with trace.span("part"):
        res = cpq.cpq_select(counts, SearchParams(k=k, max_count=max_count))
    gate = trace.searches()[0]["children"][0]
    assert gate["name"] == "cpq.gate"
    want = int((counts >= res.threshold[:, None]).sum())
    assert gate["counters"] == {"cpq.passed": want}


def test_the_process_counters_are_one_registry_behind_their_views():
    common.reset_launch_counts()
    plan_lib.reset_copied_bytes()
    common.note_launch("match_count", "tile_q=32")
    common.note_launch("match_count")
    plan_lib._COPIED["bytes"] = 4096
    got = trace.counters()
    assert got["kernel.launches"] == common.launch_counts() == {"match_count": 2}
    assert got["kernel.variant_launches"] == common.variant_launch_counts() \
        == {"match_count[tile_q=32]": 1}
    assert got["plan.copied_bytes"] == {"bytes": 4096} and plan_lib.copied_bytes() == 4096
    common.reset_launch_counts()
    plan_lib.reset_copied_bytes()
    assert trace.counters() == {"kernel.launches": {}, "kernel.variant_launches": {},
                                "plan.copied_bytes": {}}
    assert plan_lib.copied_bytes() == 0
