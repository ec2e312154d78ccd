"""Coarse routing of the port (`repro_torch.core.routing` and the routed
executors of `repro_torch.core.plan`) against the JAX package's, on the same
numpy inputs: tests/test_routing.py without its distributed cases.

Summaries (built on the tensor's device, here the CPU), merged summaries,
upper bounds and `Router.select` masks are equal to the reference's exactly.
ROUTED_VERIFIED equals the full scan, and the port's ROUTED equals the
reference's ROUTED -- ids, counts and threshold, no tolerance -- for every
engine x CPQ / SPQ / SORT, on SEGMENTED and on the MULTILOAD host loop.
The JAX package runs its plain path (use_kernel=False); the port runs its
kernel path, which on CPU tensors takes each kernel's plain version."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import engines as jengines
from repro.core import plan as jplan
from repro.core import routing as jrouting
from repro.core.types import Engine as JEngine, TopKMethod as JMethod, TopKResult as JResult
from repro_torch.core import (Engine, GenieIndex, SegmentedIndex, TopKMethod, TopKResult,
                              engines, routing)
from repro_torch.core import plan as tplan

ENGINES = [e.value for e in sorted(jengines.available(), key=lambda e: e.value)]
METHODS = ["cpq", "spq", "sort"]
# uneven on purpose (as tests/test_routing.py): a 1-row segment, a segment
# smaller than k, a big one
CUTS = [0, 3, 4, 40, 90, 101]


def _case(engine: str, n=101, q=4, seed=0):
    """The engine's seeded example data, prepared as both packages prepare it."""
    model = jengines.get(JEngine(engine))
    raw, queries, mc = model.example(np.random.default_rng(seed), n, q)
    data = model.prepare_data(raw)
    return raw, queries, np.asarray(data), model.resolve_max_count(data, mc)


def _pair(engine: str, raw, mc, layout="wide", cuts=CUTS):
    seg = SegmentedIndex(Engine(engine), max_count=mc, device="cpu", signature_layout=layout)
    jseg = JSegmentedIndex(JEngine(engine), max_count=mc, use_kernel=False,
                           signature_layout=layout)
    for a, b in zip(cuts, cuts[1:]):
        seg.add(raw[a:b])
        jseg.add(raw[a:b])
    return seg, jseg


def _same(got, want, label=""):
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids)), label
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts)), label
    assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold)), label


def _same_summary(got, want, label=""):
    assert got.engine.value == want.engine.value and got.n_rows == want.n_rows, label
    for field in ("col_min", "col_max", "centroid"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b), (label, field)
    if want.occupancy is None:
        assert got.occupancy is None, label
    else:
        assert got.occupancy.dtype == bool and np.array_equal(got.occupancy, want.occupancy), label


def _host_queries(engine: str, queries):
    """Canonical WIDE queries as host arrays, for both routers."""
    prepared = jengines.get(JEngine(engine)).prepare_queries(queries)
    if isinstance(prepared, tuple):
        return tuple(np.asarray(x) for x in prepared)
    return np.asarray(prepared)


# ---------------------------------------------------------------------------
# Summaries, merges, bounds and masks: equal to the reference, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_summaries_bounds_and_masks_equal_reference(engine):
    raw, queries, data, mc = _case(engine, q=6, seed=3)
    hq = _host_queries(engine, queries)
    ours, theirs = [], []
    for a, b in zip(CUTS, CUTS[1:]):
        want = jrouting.summarize(JEngine(engine), data[a:b])
        # the device route (a tensor) and the host route (numpy) agree
        for arg in (torch.from_numpy(data[a:b].copy()), data[a:b]):
            _same_summary(routing.summarize(engine, arg), want, f"{engine} [{a}:{b}]")
        ours.append(routing.summarize(engine, torch.from_numpy(data[a:b].copy())))
        theirs.append(want)
        assert np.array_equal(routing.upper_bound(ours[-1], hq),
                              jrouting.upper_bound(want, hq)), engine
    merged = routing.merge_summaries(ours[2], ours[3])
    _same_summary(merged, jrouting.merge_summaries(theirs[2], theirs[3]), f"{engine} merged")
    router = routing.Router(engine=Engine(engine), summaries=ours)
    jrouter = jrouting.Router(engine=JEngine(engine), summaries=theirs)
    assert router.part_rows == jrouter.part_rows and \
        router.default_nprobe() == jrouter.default_nprobe() == 3
    assert np.array_equal(router.upper_bounds(hq), jrouter.upper_bounds(hq))
    for nprobe in (None, 1, 2, 5, 9):
        mask, ubs = router.select(hq, nprobe)
        jmask, jubs = jrouter.select(hq, nprobe)
        assert np.array_equal(mask, jmask) and np.array_equal(ubs, jubs), (engine, nprobe)


@pytest.mark.parametrize("kind", ["minhash-empty-rows", "full-int32", "float-ip-whole",
                                  "float-ip-fractions", "bool-ip"])
def test_summary_value_classes_equal_reference(kind, rng):
    """Values the device route must reduce exactly as numpy does: minhash
    rows that rehash to 0xFFFFFFFF (-1 as int32: bucket 2047 by numpy's
    mod, where fmod would give -1), full-range int32 ids, IP corpora of a
    floating dtype -- whole numbers on the device, fractions on the host --
    and of bool."""
    if kind == "minhash-empty-rows":
        engine, data = "tanimoto", rng.integers(0, 254, (50, 12)).astype(np.int32)
        data[::7] = -1
        data[3, :4] = np.iinfo(np.int32).min
    elif kind == "full-int32":
        engine = "eq"
        data = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, (40, 9),
                            dtype=np.int64).astype(np.int32)
    elif kind == "float-ip-whole":
        engine, data = "ip", rng.integers(0, 2, (60, 17)).astype(np.float32)
    elif kind == "float-ip-fractions":
        engine, data = "ip", (rng.standard_normal((60, 17)) * 3).astype(np.float32)
    else:
        engine, data = "ip", rng.integers(0, 2, (60, 17)).astype(bool)
    want = jrouting.summarize(JEngine(engine), jnp.asarray(data))
    _same_summary(routing.summarize(engine, torch.from_numpy(data)), want, kind)
    _same_summary(GenieIndex.build(engine, data, max_count=64, device="cpu").summary,
                  JGenieIndex.build(JEngine(engine), data, max_count=64).summary, kind)


def test_summary_takes_the_host_route_where_an_integer_sum_could_round(monkeypatch, rng):
    """Past 2**53 a float64 sum may round, so the device route hands over
    to numpy; the result is the reference's either way."""
    data = rng.integers(0, 1000, (30, 5)).astype(np.int32)
    calls = []
    orig = routing._summarize_host
    monkeypatch.setattr(routing, "_summarize_host",
                        lambda e, a: calls.append(a.shape) or orig(e, a))
    routing.summarize("minsum", torch.from_numpy(data))
    assert calls == []
    monkeypatch.setattr(routing, "_EXACT_SUM", 1000)
    got = routing.summarize("minsum", torch.from_numpy(data))
    assert calls == [(30, 5)]
    _same_summary(got, jrouting.summarize(JEngine.MINSUM, data))


# ---------------------------------------------------------------------------
# Routed searches: VERIFIED == full scan, ROUTED == the reference's ROUTED
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("method", METHODS)
def test_routed_searches_equal_reference(engine, method):
    k = 9
    raw, queries, _, mc = _case(engine)
    seg, jseg = _pair(engine, raw, mc)
    n_seg = len(seg.segments)
    for name in ("search", "search_multiload"):
        search, jsearch = getattr(seg, name), getattr(jseg, name)
        kw, jkw = dict(method=TopKMethod(method)), dict(method=JMethod(method))
        full = jsearch(queries, k, **jkw)
        _same(search(queries, k, **kw), full, f"{engine} {method} {name} none")
        _same(search(queries, k, routing="routed_verified", nprobe=1, **kw), full,
              f"{engine} {method} {name} verified")
        for nprobe in (1, 2):
            _same(search(queries, k, routing="routed", nprobe=nprobe, **kw),
                  jsearch(queries, k, routing="routed", nprobe=nprobe, **jkw),
                  f"{engine} {method} {name} routed nprobe={nprobe}")
        _same(search(queries, k, routing="routed", nprobe=n_seg, **kw), full,
              f"{engine} {method} {name} all probes")


@pytest.mark.parametrize("engine", ["cosine", "tanimoto"])
def test_routed_packed_searches_equal_reference(engine):
    """PACKED segments: the router reads the canonical WIDE queries, the
    executor the packed ones (the fused kernel's plain version on
    SEGMENTED, the packed count on the host loop)."""
    raw, queries, _, mc = _case(engine)
    seg, jseg = _pair(engine, raw, mc, layout="packed")
    for name in ("search", "search_multiload"):
        search, jsearch = getattr(seg, name), getattr(jseg, name)
        full = jsearch(queries, 9)
        _same(search(queries, 9, routing="routed_verified", nprobe=1), full, name)
        _same(search(queries, 9, routing="routed", nprobe=2),
              jsearch(queries, 9, routing="routed", nprobe=2), name)


@pytest.mark.parametrize("engine", ["eq", "cosine", "range"])
def test_compaction_merges_summaries_and_keeps_parity(engine):
    raw, queries, _, mc = _case(engine)
    seg, jseg = _pair(engine, raw, mc)
    full = jseg.search(queries, 9)
    seg.compact(2)
    jseg.compact(2)
    assert len(seg.segments) == 2
    for ours, theirs in zip(seg.segments, jseg.segments):
        _same_summary(ours.summary, theirs.summary, f"{engine} compacted")
    _same(seg.search(queries, 9, routing="routed_verified", nprobe=1), full, engine)
    _same(seg.search(queries, 9, routing="routed", nprobe=1),
          jseg.search(queries, 9, routing="routed", nprobe=1), engine)
    # a summary-less source poisons the merge: router() names the segment
    seg.segments[0] = dataclasses.replace(seg.segments[0], summary=None)
    seg.compact(1)
    assert seg.segments[0].summary is None
    with pytest.raises(ValueError, match="segments \\[0\\]"):
        seg.router()


# ---------------------------------------------------------------------------
# The router skips -- and falls back
# ---------------------------------------------------------------------------

def _spy_part_rows(monkeypatch) -> list:
    """Rows of every part the executor matches (`_part_topk`'s data)."""
    seen = []
    orig = tplan._part_topk

    def spy(plan, data, queries, offset, k=None):
        seen.append(int(data.shape[0]))
        return orig(plan, data, queries, offset, k)

    monkeypatch.setattr(tplan, "_part_topk", spy)
    return seen


def _cold_and_hot(cold_value: int):
    seg = SegmentedIndex(Engine.EQ, device="cpu")
    jseg = JSegmentedIndex(JEngine.EQ, use_kernel=False)
    for rows, value in ((40, cold_value), (35, 7)):
        part = np.full((rows, 16), value, dtype=np.int32)
        seg.add(part)
        jseg.add(part)
    return seg, jseg, np.full((2, 16), 7, dtype=np.int32)


@pytest.mark.parametrize("name", ["search", "search_multiload"])
def test_routed_skips_cold_segment_without_matching_it(name, monkeypatch):
    """A segment the router rules out (UB 0 under the threshold 16) is never
    matched: `_part_topk` sees only the 35 hot rows."""
    seg, jseg, q = _cold_and_hot(0)
    seen = _spy_part_rows(monkeypatch)
    verified = getattr(seg, name)(q, 5, routing="routed_verified", nprobe=1)
    assert seen == [35]
    _same(verified, getattr(jseg, name)(q, 5))


@pytest.mark.parametrize("name", ["search", "search_multiload"])
def test_verified_falls_back_on_tied_upper_bound(name, monkeypatch):
    """Identical segments tie the routed threshold: the verified mode must
    rescan (a tied count with a smaller id displaces the k-th slot)."""
    seg, jseg, q = _cold_and_hot(7)
    seen = _spy_part_rows(monkeypatch)
    verified = getattr(seg, name)(q, 5, routing="routed_verified", nprobe=1)
    assert seen[:1] == [40] and sorted(seen[1:]) == [35, 40]
    _same(verified, getattr(jseg, name)(q, 5))


def test_unfilled_topk_slot_forces_fallback():
    """threshold -1 (an unfilled k-th slot) always falls back; a bound equal
    to the threshold does too; strictly smaller bounds do not -- for host
    thresholds and tensors alike, as in the reference."""
    verify = np.array([False, True])
    cases = [(np.zeros((1, 2)), -1, True), (np.array([[9.0, 2.0]]), 3, False),
             (np.array([[0.0, 3.0]]), 3, True)]
    for ubs, thr, want in cases:
        two = np.full((1, 2), -1, dtype=np.int32)
        jres = JResult(ids=two, counts=two, threshold=np.array([thr]))
        assert jplan._skipped_could_contribute(jres, ubs, verify) is want
        for wrap in (np.asarray, torch.tensor):
            res = TopKResult(ids=two, counts=two, threshold=wrap([thr]))
            assert tplan._skipped_could_contribute(res, ubs, verify) is want
    assert not tplan._skipped_could_contribute(
        TopKResult(ids=two, counts=two, threshold=np.array([-1])), np.zeros((1, 2)),
        np.array([False, False]))


def test_routed_search_on_one_tied_bound_unfilled_slot():
    """k above a routed part's rows leaves a slot unfilled (threshold -1):
    the verified search falls back and equals the full scan."""
    seg, jseg, q = _cold_and_hot(0)
    _same(seg.search(q, 50, routing="routed_verified", nprobe=1), jseg.search(q, 50))
    _same(seg.search(q, 50, routing="routed", nprobe=1),
          jseg.search(q, 50, routing="routed", nprobe=1))


# ---------------------------------------------------------------------------
# Plan plumbing: validation, describe(), equality, execute() contracts
# ---------------------------------------------------------------------------

def test_plan_rejects_routing_on_single_pass_layouts():
    for planner, engine in ((tplan.plan_search, Engine.EQ), (jplan.plan_search, JEngine.EQ)):
        with pytest.raises(ValueError, match="nothing to skip"):
            planner(engine, 5, 16, routing="routed")
        with pytest.raises(ValueError, match="nothing to skip"):
            planner(engine, 5, 16, layout="multiload", n_parts=4, n_objects=101,
                    routing="routed")
        with pytest.raises(ValueError, match="nprobe must be >= 1, got 0"):
            planner(engine, 5, 16, layout="segmented", part_rows=(3, 4), routing="routed",
                    nprobe=0)


@pytest.mark.parametrize("routing_mode,nprobe", [("none", 7), ("routed", None),
                                                 ("routed_verified", 2)])
@pytest.mark.parametrize("layout,host_loop", [("segmented", False), ("multiload", True)])
def test_routed_plan_describe_and_equality(routing_mode, nprobe, layout, host_loop):
    kw = dict(layout=layout, part_rows=(3, 4), n_objects=7 if host_loop else None,
              host_loop=host_loop, routing=routing_mode, nprobe=nprobe)
    got = tplan.plan_search(Engine.EQ, 5, 16, **kw)
    want = jplan.plan_search(JEngine.EQ, 5, 16, **kw)
    got_d, want_d = got.describe(), want.describe()
    if host_loop:   # the one stated difference: the histogram kernel on MULTILOAD
        assert got_d.pop("fused_hist") is True and want_d.pop("fused_hist") is False
    assert got_d == want_d
    full = tplan.plan_search(Engine.EQ, 5, 16, **{**kw, "routing": "none", "nprobe": None})
    assert (got == full) is (routing_mode == "none")
    # a full-scan plan drops nprobe so equal searches plan equal
    assert full.nprobe is None and (got.nprobe == nprobe or routing_mode == "none")


def test_execute_validates_router():
    raw, queries, _, mc = _case("eq")
    seg, jseg = _pair("eq", raw, mc)
    plan = tplan.plan_search(Engine.EQ, 5, mc, layout="segmented",
                             part_rows=tuple(seg.segment_rows), routing="routed")
    parts = [s.data for s in seg.segments]
    q = engines.get(Engine.EQ).prepare_queries(queries, torch.device("cpu"))
    with pytest.raises(ValueError, match="router="):
        tplan.execute(plan, parts, q)
    stale, _ = _pair("eq", raw, mc, cuts=[0, 50, 101])
    with pytest.raises(ValueError, match="rebuild the router"):
        tplan.execute(plan, parts, q, router=stale.router())
    # the router of the current segments runs; route_queries defaults to q
    got = tplan.execute(plan, parts, q, router=seg.router())
    _same(got, jseg.search(queries, 5, routing="routed"))


def test_router_and_summary_validation():
    cases = [
        (lambda r: r.Router(engine="eq", summaries=[]), "at least one"),
        (lambda r: r.summarize("eq", np.zeros((0, 4), dtype=np.int32)), "non-empty"),
        (lambda r: r.summarize("eq", np.zeros(4, dtype=np.int32)), "non-empty"),
        (lambda r: r.merge_summaries(r.summarize("eq", np.zeros((3, 4), np.int32)),
                                     r.summarize("cosine", np.ones((3, 4), np.int8))),
         "engines"),
        (lambda r: r.merge_summaries(r.summarize("eq", np.zeros((3, 4), np.int32)),
                                     r.summarize("eq", np.zeros((3, 6), np.int32))),
         "widths"),
        (lambda r: r.Router(engine="eq",
                            summaries=[r.summarize("cosine", np.ones((3, 4), np.int8))]),
         "router engine"),
    ]
    for act, text in cases:
        with pytest.raises(ValueError, match=text) as ours:
            act(routing)
        with pytest.raises(ValueError) as theirs:
            act(jrouting)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="nprobe must be >= 1"):
        routing.Router(engine="eq", summaries=[routing.summarize(
            "eq", np.zeros((3, 4), np.int32))]).select(np.zeros((1, 4), np.int32), 0)
    with pytest.raises(ValueError, match="add\\(\\) first"):
        SegmentedIndex(Engine.EQ, device="cpu").router()
    with pytest.raises(ValueError, match="occupancy"):
        routing.upper_bound(dataclasses.replace(
            routing.summarize("eq", np.zeros((3, 4), np.int32)), occupancy=None),
            np.zeros((1, 4), np.int32))


def test_shard_helpers_equal_reference(rng):
    for _ in range(20):
        rows = [int(r) for r in rng.integers(1, 30, rng.integers(1, 8))]
        mask = rng.random(len(rows)) < 0.5
        n_local = int(rng.integers(1, 25))
        n_shards = -(-sum(rows) // n_local) + int(rng.integers(0, 3))
        active = routing.shard_mask(rows, mask, n_local, n_shards)
        assert np.array_equal(active, jrouting.shard_mask(rows, mask, n_local, n_shards))
        assert np.array_equal(routing.segments_needing_verify(rows, active, n_local),
                              jrouting.segments_needing_verify(rows, active, n_local))


@pytest.mark.parametrize("engine", ENGINES)
def test_upper_bound_is_sound_per_segment(engine):
    """UB >= the real per-segment max count (the port's plain counts): the
    property ROUTED_VERIFIED's exactness rests on."""
    raw, queries, data, mc = _case(engine, q=6, seed=5)
    model = engines.get(Engine(engine))
    cpu = torch.device("cpu")
    tq = model.prepare_queries(queries, cpu)
    counts = model.reference(model.prepare_data(raw, cpu), tq).numpy()
    hq = _host_queries(engine, queries)
    for a, b in zip(CUTS, CUTS[1:]):
        ub = routing.upper_bound(routing.summarize(engine, torch.from_numpy(data[a:b].copy())),
                               hq)
        assert (ub >= counts[:, a:b].max(axis=1)).all(), (engine, a, b)


# ---------------------------------------------------------------------------
# The service's router cache
# ---------------------------------------------------------------------------

def test_service_router_cache_refreshes_exactly_on_corpus_change(rng):
    from repro_torch.serve import RetrievalService

    pts = rng.standard_normal((96, 6)).astype(np.float32)
    svc = RetrievalService(embed_fn=np.asarray, m_override=8, max_segments=2, device="cpu")
    svc.add(list(range(32)), embeddings=pts[:32])
    builds = []
    orig = svc._index.router
    svc._index.router = lambda: builds.append(1) or orig()
    q = pts[:4] + 0.01

    def routed_search():
        return svc.search(None, k=3, embeddings=q, routing="routed_verified", nprobe=1)

    routed_search()
    routed_search()
    assert len(builds) == 1                  # cached: fingerprint unchanged
    svc.add(list(range(32, 64)), embeddings=pts[32:64])
    routed_search()
    routed_search()
    assert len(builds) == 2                  # add() changed the fingerprint
    svc.add(list(range(64, 96)), embeddings=pts[64:])   # past max_segments: compaction
    assert svc._index.compaction_count == 1
    res, _ = routed_search()
    assert len(builds) == 3
    full, _ = svc.search(None, k=3, embeddings=q)
    assert torch.equal(res.ids, full.ids) and torch.equal(res.counts, full.counts)
    svc.search(None, k=3, embeddings=q)      # a full scan builds no router
    assert len(builds) == 3


# ---------------------------------------------------------------------------
# The reference's keyword set, at its defaults, on every entry point
# ---------------------------------------------------------------------------

def test_entry_points_take_the_reference_keywords_at_their_defaults(rng, tmp_path, monkeypatch):
    """The smallest case of the fault: a 3 x 4 EQ index searched with
    `tile_overrides=None` gave [[0], [1], [2]] in the reference and a
    TypeError in the port.  Every search entry point now takes the
    reference's full keyword set at its defaults with the reference's
    result; the autotuner's keywords (ROADMAP queue 1 item 8) and the
    distributed layout's (item 9), ported since, plan and search with other
    values as the reference does."""
    # the default caches of both packages: files that do not exist
    monkeypatch.setenv("GENIE_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("GENIE_TORCH_AUTOTUNE_CACHE", str(tmp_path / "torch.json"))
    data = np.arange(12, dtype=np.int32).reshape(3, 4)
    idx = GenieIndex.build(Engine.EQ, data, device="cpu")
    jidx = JGenieIndex.build(JEngine.EQ, data)
    tiles = dict(tile_overrides=None, autotune=None)
    _same(idx.search(data, k=1, **tiles), jidx.search(data, k=1, **tiles))
    assert idx.search(data, k=1, **tiles).ids.tolist() == [[0], [1], [2]]
    _same(idx.search_multiload(data, k=1, n_parts=2, **tiles),
          jidx.search_multiload(data, k=1, n_parts=2, **tiles))
    seg, jseg = SegmentedIndex(Engine.EQ, device="cpu"), JSegmentedIndex(JEngine.EQ)
    for part in (data[:2], data[2:]):
        seg.add(part)
        jseg.add(part)
    seg_kw = dict(routing="none", nprobe=None, router=None, **tiles)
    _same(seg.search(data, k=2, **seg_kw), jseg.search(data, k=2, **seg_kw))
    _same(seg.search_multiload(data, k=2, **seg_kw), jseg.search_multiload(data, k=2, **seg_kw))
    plan_kw = dict(layout="segmented", part_rows=(2, 1), hierarchical=False, mesh_axes=(),
                   nprobe=None, tile_overrides=None, autotune=None, tune_width=None)
    plan = tplan.plan_search(Engine.EQ, 2, 4, **plan_kw)
    jp = jplan.plan_search(JEngine.EQ, 2, 4, **plan_kw)
    assert plan.describe() == jp.describe()
    q = torch.from_numpy(data)
    _same(tplan.execute(plan, [s.data for s in seg.segments], q, mesh=None, router=None,
                        route_queries=None),
          jplan.execute(jp, [s.data for s in jseg.segments], jnp.asarray(data), mesh=None,
                        router=None, route_queries=None))
    # the autotuner's keywords (item 8) with values: the reference's result
    cache = str(tmp_path / "cache.json")
    tuned = [
        (lambda i, s: i.search(data, k=1, tile_overrides={"tile_n": 256})),
        (lambda i, s: i.search(data, k=1, autotune=True)),
        (lambda i, s: i.search_multiload(data, k=1, n_parts=2, autotune=cache)),
        (lambda i, s: s.search(data, k=1, tile_overrides={"tile_q": 8})),
        (lambda i, s: s.search_multiload(data, k=1, autotune=True)),
    ]
    for act in tuned:
        _same(act(idx, seg), act(jidx, jseg))
    assert (tplan.plan_search(Engine.EQ, 2, 4, tune_width=4).describe()
            == jplan.plan_search(JEngine.EQ, 2, 4, tune_width=4).describe())
    # the distributed layout's keywords (item 9, ported since) with values:
    # the reference's plans and results, on a one-rank gloo mesh against its
    # one-device mesh
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh

    mesh, jm = tmesh.make_mesh((1,), ("data",), device="cpu"), jmesh.make_mesh((1,), ("data",))
    for kw in (dict(hierarchical=True), dict(mesh_axes=("data",))):
        assert (tplan.plan_search(Engine.EQ, 2, 4, **kw).describe()
                == jplan.plan_search(JEngine.EQ, 2, 4, **kw).describe())
    # a SEGMENTED plan ignores mesh=, in both packages
    _same(tplan.execute(plan, [s.data for s in seg.segments], q, mesh=mesh),
          jplan.execute(jp, [s.data for s in jseg.segments], jnp.asarray(data), mesh=jm))
    dist_kw = dict(layout="distributed", mesh_axes=("data",), hierarchical=True)
    _same(tplan.execute(tplan.plan_search(Engine.EQ, 2, 4, **dist_kw), q, q, mesh=mesh),
          jplan.execute(jplan.plan_search(JEngine.EQ, 2, 4, **dist_kw), jnp.asarray(data),
                        jnp.asarray(data), mesh=jm))
