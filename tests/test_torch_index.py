"""GenieIndex, SegmentedIndex and the planner of the port against the JAX
package, built from identical int32 signatures: ids, counts and thresholds
must be equal for all three selection methods, through uneven and tiny
segments, compaction and padded monolithic plans."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex, SegmentedIndex as JSegmentedIndex
from repro.core import engines as jengines, plan as jplan
from repro.core.types import Engine as JEngine, TopKMethod as JMethod
from repro_torch.core import (Engine, GenieIndex, Layout, Routing, SegmentedIndex,
                              TopKMethod, engines, execute, plan_search)
from repro_torch.core import plan as tplan
from repro_torch.core.segments import even_segments, layout_accounting
from repro_torch.core.types import SignatureLayout

METHODS = ["cpq", "spq", "sort"]


def _sigs(rng, n, m=24, buckets=6):
    return rng.integers(0, buckets, size=(n, m)).astype(np.int32)


def _same(got, want):
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_genie_index_equals_reference(method, use_kernel, rng):
    data, q = _sigs(rng, 400), _sigs(rng, 9)
    idx = GenieIndex.build(Engine.EQ, data, use_kernel=use_kernel, device="cpu")
    jidx = JGenieIndex.build(JEngine.EQ, data, use_kernel=use_kernel)
    assert idx.max_count == jidx.max_count == 24
    # the seal-time routing summary, built on the index's device, equals the
    # reference's array for array
    for field in ("col_min", "col_max", "centroid", "occupancy"):
        assert np.array_equal(getattr(idx.summary, field), getattr(jidx.summary, field)), field
    assert idx.summary.n_rows == jidx.summary.n_rows == 400
    assert np.array_equal(idx.match_counts(q).numpy(), np.asarray(jidx.match_counts(q)))
    _same(idx.search(q, k=15, method=TopKMethod(method)),
          jidx.search(q, k=15, method=JMethod(method)))
    _same(idx.search(torch.from_numpy(q), k=15, method=TopKMethod(method), candidate_cap=15),
          jidx.search(q, k=15, method=JMethod(method), candidate_cap=15))


def test_index_stats_equal_reference(rng):
    data = _sigs(rng, 130, m=17)
    a = GenieIndex.build_lsh(data, device="cpu").stats
    b = JGenieIndex.build_lsh(data).stats
    for field in ("n_objects", "n_lists", "total_postings", "max_list_len", "bytes_device",
                  "signature_layout", "bytes_signatures_wide", "bytes_signatures_packed",
                  "n_segments", "segment_rows", "compaction_count", "extra"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.build_seconds >= 0.0


def test_build_accepts_tensors_and_explicit_bound(rng):
    data = _sigs(rng, 50, m=8)
    idx = GenieIndex.build("eq", torch.from_numpy(data).to(torch.int64), max_count=5, device="cpu")
    assert idx.data.dtype == torch.int32 and idx.data.is_contiguous() and idx.max_count == 5
    assert idx.engine is Engine.EQ and idx.model is engines.get("eq")
    assert torch.equal(idx.prepare_queries(data[:3]), torch.from_numpy(data[:3]))


ROWS = {
    "uneven": [37, 101, 5, 64, 20],
    "tiny-below-k": [3, 2, 40, 1, 7],
    "single": [90],
    "equal": [32, 32, 32],
}


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("method", METHODS)
def test_segmented_index_equals_reference(rows, method, rng):
    rows = ROWS[rows]
    data, q = _sigs(rng, sum(rows)), _sigs(rng, 6)
    seg = SegmentedIndex(Engine.EQ, device="cpu")
    jseg = JSegmentedIndex(JEngine.EQ)
    start = 0
    for r in rows:
        seg.add(data[start:start + r])
        jseg.add(data[start:start + r])
        start += r
    assert seg.segment_rows == jseg.segment_rows == rows and len(seg) == len(jseg)
    want = jseg.search(q, k=10, method=JMethod(method))
    _same(seg.search(q, k=10, method=TopKMethod(method)), want)
    # a segmented search equals the monolithic one (the reference's invariant)
    if sum(rows) >= 10:
        _same(GenieIndex.build(Engine.EQ, data, device="cpu").search(
            q, k=10, method=TopKMethod(method)), want)
    # compaction never remaps an id
    seg.compact(max_segments=2)
    jseg.compact(max_segments=2)
    assert seg.segment_rows == jseg.segment_rows
    assert seg.compaction_count == jseg.compaction_count
    _same(seg.search(q, k=10, method=TopKMethod(method)), want)
    a, b = seg.stats, jseg.stats
    for field in ("n_objects", "n_lists", "total_postings", "bytes_device", "n_segments",
                  "segment_rows", "compaction_count", "bytes_signatures_wide"):
        assert getattr(a, field) == getattr(b, field), field


def test_from_segments_rebuilds_the_reference_state(rng):
    rows = [12, 50, 7]
    data, q = _sigs(rng, sum(rows)), _sigs(rng, 4)
    jseg = JSegmentedIndex(JEngine.EQ)
    start = 0
    for r in rows:
        jseg.add(data[start:start + r])
        start += r
    seg = SegmentedIndex.from_segments([np.asarray(s.data) for s in jseg.segments],
                                       max_count=jseg.max_count, device="cpu")
    assert seg.segment_rows == rows and seg.max_count == jseg.max_count
    _same(seg.search(q, k=8), jseg.search(q, k=8))


def test_segmented_index_validation(rng):
    seg = SegmentedIndex(Engine.EQ, device="cpu")
    with pytest.raises(ValueError, match="empty SegmentedIndex"):
        seg.search(_sigs(rng, 2), k=3)
    with pytest.raises(ValueError, match="empty SegmentedIndex"):
        seg.concat_data()
    with pytest.raises(ValueError, match="cannot add an empty batch"):
        seg.add(np.zeros((0, 24), np.int32))
    seg.add(_sigs(rng, 10))
    with pytest.raises(ValueError, match="segment width mismatch"):
        seg.add(_sigs(rng, 10, m=7))
    with pytest.raises(ValueError, match="max_segments must be >= 1"):
        seg.compact(0)
    with pytest.raises(ValueError, match="no packed signature format"):
        SegmentedIndex(Engine.EQ, signature_layout="packed", device="cpu")
    # routed search is ported: on one segment ROUTED equals the reference's
    jseg = JSegmentedIndex(JEngine.EQ)
    jseg.add(np.asarray(seg.segments[0].data))
    q = _sigs(rng, 2)
    _same(seg.search(q, k=3, routing="routed"), jseg.search(q, k=3, routing="routed"))
    # an engine with no derivable count bound: the first add needs max_count,
    # and says so in the reference's words
    with pytest.raises(ValueError) as ours:
        SegmentedIndex(Engine.MINSUM, device="cpu").add(_sigs(rng, 4))
    with pytest.raises(ValueError) as theirs:
        JSegmentedIndex(JEngine.MINSUM).add(_sigs(rng, 4))
    assert str(ours.value) == str(theirs.value) == (
        "engine 'minsum' has no derivable count bound; pass max_count explicitly")


def test_concat_data_pads_and_a_padded_plan_masks(rng):
    """MONOLITHIC plan over engine-padded data: pad rows never reach a
    result, exactly as in the reference."""
    rows = [30, 11]
    data = _sigs(rng, sum(rows), buckets=3)
    q = np.full((3, 24), -1, np.int32)          # matches only the -1 pad rows
    q[1] = data[4]
    seg = SegmentedIndex(Engine.EQ, device="cpu")
    jseg = JSegmentedIndex(JEngine.EQ)
    for lo, hi in ((0, 30), (30, 41)):
        seg.add(data[lo:hi])
        jseg.add(data[lo:hi])
    padded, n = seg.concat_data(pad_multiple=16)
    jpadded, jn = jseg.concat_data(pad_multiple=16)
    assert n == jn == 41 and tuple(padded.shape) == (48, 24)
    assert np.array_equal(padded.numpy(), np.asarray(jpadded))
    for method in METHODS:
        for k in (30, 45):                          # below and above the 41 real rows
            plan = plan_search(Engine.EQ, k, 24, part_rows=(48,), n_objects=n,
                               method=TopKMethod(method))
            jp = jplan.plan_search(JEngine.EQ, k, 24, part_rows=(48,), n_objects=n,
                                   method=JMethod(method))
            assert plan.pad_rows == jp.pad_rows == 7
            got = execute(plan, padded, torch.from_numpy(q))
            _same(got, jplan.execute(jp, jpadded, jnp.asarray(q)))
            # pad-never-in-top-k: a pad row never holds a slot with a count;
            # (with k above the real rows the reference's full sort hands the
            # left-over slots to pad ids at count -1, and so does the port)
            assert bool((got.counts[got.ids >= n] == -1).all())
            if k <= n:
                assert int(got.ids.max()) < n


@pytest.mark.parametrize("layout,rows,n_objects", [
    ("monolithic", (300,), None), ("monolithic", (304,), 300),
    ("segmented", (40, 3, 200), None), ("segmented", tuple(range(1, 41)), None)])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_describe_equals_reference_where_ported(layout, rows, n_objects, use_kernel):
    kw = dict(layout=layout, part_rows=rows, n_objects=n_objects, method="spq",
              candidate_cap=33, use_kernel=use_kernel)
    got = plan_search("eq", 12, 24, **{**kw, "method": TopKMethod.SPQ}).describe()
    want = jplan.plan_search("eq", 12, 24, **{**kw, "method": JMethod.SPQ}).describe()
    assert got["fused_hist"] is use_kernel
    assert set(got) <= set(want)
    assert got == {key: want[key] for key in got}
    # every key of the reference is there
    assert set(want) - set(got) == set()


@pytest.mark.parametrize("hierarchical,axes", [(False, ("data", "model")),
                                               (True, ("pod", "data", "model"))])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_describe_of_a_distributed_plan_equals_reference(hierarchical, axes, use_kernel):
    """Every key of the reference's DISTRIBUTED plan, but `fused_hist`: the
    port keeps the histogram kernel on its kernel path (core/plan.py)."""
    kw = dict(layout="distributed", n_objects=130, candidate_cap=21, use_kernel=use_kernel,
              hierarchical=hierarchical, mesh_axes=axes)
    got = plan_search("eq", 12, 24, **kw).describe()
    want = jplan.plan_search("eq", 12, 24, **kw).describe()
    assert got["merge"] == ("collective-hierarchical" if hierarchical else "collective")
    assert got["fused_hist"] is use_kernel and want["fused_hist"] is False
    assert {**got, "fused_hist": False} == want


def test_plan_is_hashable_and_validates():
    a = plan_search(Engine.EQ, 5, 24, layout=Layout.SEGMENTED, part_rows=(4, 9))
    b = plan_search("eq", 5, 24, layout="segmented", part_rows=[4, 9])
    assert a == b and hash(a) == hash(b) and a.params.use_kernel and a.routing is Routing.NONE
    assert a.describe()["fused_hist"] is True
    assert a.n_parts == 2 and a.total_rows == 13 and a.part_k(4) == 4 and a.part_k(9) == 5
    assert plan_search(Engine.EQ, 5, 24, use_kernel=False).describe()["fused_hist"] is False
    with pytest.raises(ValueError, match="requires part_rows"):
        plan_search(Engine.EQ, 5, 24, layout=Layout.SEGMENTED)
    with pytest.raises(ValueError, match="monolithic layout got 2 parts"):
        plan_search(Engine.EQ, 5, 24, part_rows=(3, 4))
    with pytest.raises(ValueError, match="part_rows must be positive"):
        plan_search(Engine.EQ, 5, 24, layout=Layout.SEGMENTED, part_rows=(3, 0))
    with pytest.raises(ValueError, match="no packed signature format"):
        plan_search(Engine.EQ, 5, 24, signature_layout=SignatureLayout.PACKED)
    # the distributed layout plans as the reference plans it, routed or not,
    # and executes only on a mesh, with the reference's error
    dist = plan_search(Engine.EQ, 5, 24, layout=Layout.DISTRIBUTED, part_rows=(3,))
    assert dist.layout is Layout.DISTRIBUTED and dist.merge_strategy() == "collective"
    routed = plan_search(Engine.EQ, 5, 24, layout=Layout.SEGMENTED, part_rows=(3,),
                         routing=Routing.ROUTED_VERIFIED, nprobe=2)
    assert routed.routing is Routing.ROUTED_VERIFIED and routed.nprobe == 2
    routed = plan_search(Engine.EQ, 5, 24, layout=Layout.DISTRIBUTED, part_rows=(3,),
                         routing=Routing.ROUTED_VERIFIED)
    assert routed.routing is Routing.ROUTED_VERIFIED and routed.nprobe is None
    for plan in (dist, routed):
        with pytest.raises(ValueError, match="a DISTRIBUTED plan executes on a mesh; pass mesh="):
            execute(plan, torch.zeros((4, 24), dtype=torch.int32),
                    torch.zeros((1, 24), dtype=torch.int32))
    with pytest.raises(ValueError, match="plan lays out 2 parts"):
        execute(a, [torch.zeros((4, 24), dtype=torch.int32)], torch.zeros((1, 24), dtype=torch.int32))
    with pytest.raises(ValueError, match="plan says 9"):
        execute(a, [torch.zeros((4, 24), dtype=torch.int32)] * 2,
                torch.zeros((1, 24), dtype=torch.int32))


def test_raw_callable_plans(rng):
    """A bare fn(data, queries) -> counts plans like an engine."""
    data, q = _sigs(rng, 60), _sigs(rng, 3)
    fn = lambda d, s: (s[:, None, :] == d[None, :, :]).sum(-1, dtype=torch.int32)  # noqa: E731
    plan = plan_search(fn, 7, 24, layout=Layout.SEGMENTED, part_rows=(25, 35), use_kernel=False)
    assert plan.engine is None and plan.describe()["engine"] == "<callable>"
    td = torch.from_numpy(data)
    got = execute(plan, [td[:25], td[25:]], torch.from_numpy(q))
    _same(got, JGenieIndex.build(JEngine.EQ, data).search(q, k=7))


@pytest.mark.parametrize("k,bucket", [(1, 1), (2, 2), (5, 8), (8, 8), (100, 128)])
def test_k_bucket_and_batch_compat_key(k, bucket):
    assert tplan.k_bucket(k) == jplan.k_bucket(k) == bucket
    got = tplan.batch_compat_key("eq", "segmented", "wide", "none", "cpq", k)
    want = jplan.batch_compat_key("eq", "segmented", "wide", "none", "cpq", k)
    assert [getattr(x, "value", x) for x in got] == [getattr(x, "value", x) for x in want]
    pinned = tplan.batch_compat_key("eq", "segmented", "wide", "none", "cpq", k, candidate_cap=50)
    assert pinned[5] == k and pinned[7] == 50
    with pytest.raises(ValueError, match="k must be >= 1"):
        tplan.k_bucket(0)


def test_segment_helpers_equal_reference():
    from repro.core import segments as jsegments
    for n, s in [(10, 3), (4_500_000, 16), (5, 5), (3, 7)]:
        assert even_segments(n, s) == jsegments.even_segments(n, s)
    assert layout_accounting([3, 9], 96) == jsegments.layout_accounting([3, 9], 96)
    with pytest.raises(ValueError):
        even_segments(5, 0)


def test_engine_registry(rng):
    model = engines.get(Engine.EQ)
    assert [e.value for e in engines.available()] == [e.value for e in jengines.available()]
    assert engines.get(model) is model
    assert model.count_dtype(100) == torch.int8 and model.count_dtype(238) == torch.int16
    assert model.count_dtype(40000) == torch.int32
    assert model.as_count_dtype(torch.tensor([3], dtype=torch.int32), 5).dtype == torch.int8
    assert model.pad_value_for("wide") == -1 and not model.supports_packed
    data, q, max_count = model.example(rng, 30, 4)
    assert max_count is None
    idx = GenieIndex.build(Engine.EQ, data, device="cpu")
    _same(idx.search(q, k=5), JGenieIndex.build(JEngine.EQ, data).search(q, k=5))
