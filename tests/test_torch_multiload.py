"""Multiple loading (paper section III-D) of the port against the JAX package:
`GenieIndex.search_multiload` (the scanned form over a stacked tensor),
`multiload_search` / `multiload_search_host` and
`SegmentedIndex.search_multiload` (the host loop), for every engine, both
signature layouts where the engine has them, and CPQ / SPQ / SORT.

The same numpy inputs go through `repro.*` (plain path) and through
`repro_torch.*` on the CPU, where the kernel wrappers take their plain
versions; ids, counts and threshold must be equal, no tolerance.  The host
loop's copies from pinned memory onto the card are held against the
device-resident search by tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import engines as jengines, match as jmatch, multiload as jmultiload
from repro.core import plan as jplan
from repro.core.types import Engine as JEngine, SearchParams as JSearchParams
from repro.core.types import TopKMethod as JMethod
from repro_torch.core import (Engine, GenieIndex, Layout, SearchParams, SegmentedIndex,
                              TopKMethod, engines, match, multiload, plan_search)
from repro_torch.core import plan as tplan

METHODS = ["cpq", "spq", "sort"]
CPU = torch.device("cpu")


def _same(got, want):
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold))


def _same_or_both_refuse(search, jsearch, method, rows, k):
    """Equal results; or, where a SORT plan meets a part of fewer rows than k
    (the reference's lax.top_k refuses it), a ValueError from both."""
    if method == "sort" and rows < k:
        with pytest.raises(ValueError):
            jsearch()
        with pytest.raises(ValueError, match="exceeds"):
            search()
        return None
    got = search()
    _same(got, jsearch())
    return got


# ---------------------------------------------------------------------------
# GenieIndex.search_multiload: the cases of tests/test_multiload.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(10))
def test_search_multiload_equals_reference(case):
    draw = np.random.default_rng(5000 + case)
    n = int(draw.integers(20, 201))
    parts = int(draw.integers(1, 7))
    k = int(draw.integers(1, 9))
    sigs = draw.integers(0, 8, (n, 12)).astype(np.int32)
    qs = draw.integers(0, 8, (3, 12)).astype(np.int32)
    method = METHODS[case % 3]
    idx = GenieIndex.build_lsh(sigs, use_kernel=case % 2 == 0, device="cpu")
    jidx = JGenieIndex.build_lsh(sigs, use_kernel=False)
    got = _same_or_both_refuse(
        lambda: idx.search_multiload(qs, k=k, n_parts=parts, method=TopKMethod(method)),
        lambda: jidx.search_multiload(qs, k=k, n_parts=parts, method=JMethod(method)),
        method, -(-n // parts), k)
    if got is not None:
        assert np.array_equal(got.counts.numpy(), idx.search(qs, k=k).counts.numpy())


@pytest.mark.parametrize("n,parts,k", [(50, 7, 5),      # 7 parts do not divide 50: padded
                                       (30, 6, 9),      # parts of 5 rows, below k
                                       (17, 17, 3),     # one row a part
                                       (9, 4, 20)])     # k above every row: -1 slots
def test_search_multiload_pads_and_small_parts(n, parts, k, rng):
    sigs = rng.integers(0, 5, (n, 10)).astype(np.int32)
    qs = rng.integers(0, 5, (4, 10)).astype(np.int32)
    idx = GenieIndex.build_lsh(sigs, device="cpu")
    jidx = JGenieIndex.build_lsh(sigs, use_kernel=False)
    for method in METHODS:
        got = _same_or_both_refuse(
            lambda: idx.search_multiload(qs, k=k, n_parts=parts, method=TopKMethod(method)),
            lambda: jidx.search_multiload(qs, k=k, n_parts=parts, method=JMethod(method)),
            method, -(-n // parts), k)
        # pad-never-in-top-k: no id past the real rows holds a count
        assert got is None or bool((got.counts[got.ids >= n] == -1).all())


# ---------------------------------------------------------------------------
# multiload_search / multiload_search_host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "cpu-tensor"])
def test_multiload_search_host_ragged_parts_equal_reference(as_tensor, rng):
    sigs = rng.integers(0, 6, (131, 12)).astype(np.int32)
    qs = rng.integers(0, 6, (5, 12)).astype(np.int32)
    cuts = [0, 40, 43, 100, 131]                     # ragged, one part below k
    parts = [sigs[a:b] for a, b in zip(cuts, cuts[1:])]
    tparts = [torch.from_numpy(p) for p in parts] if as_tensor else parts
    for method in METHODS:
        params = SearchParams(k=7, max_count=12, method=TopKMethod(method))
        jparams = JSearchParams(k=7, max_count=12, method=JMethod(method), use_kernel=False)
        got = multiload.multiload_search_host(tparts, torch.from_numpy(qs), params,
                                              match.match_eq)
        want = jmultiload.multiload_search_host(parts, jnp.asarray(qs), jparams,
                                                jmatch.match_eq)
        _same(got, want)
        # the registry's engine name plans the same search
        _same(multiload.multiload_search_host(tparts, torch.from_numpy(qs), params, Engine.EQ),
              want)
    assert multiload._mask_pad_counts is tplan._mask_pad_counts
    assert multiload._mask_invalid is tplan._mask_invalid


def test_multiload_search_stacked_chunks_mask_pads(rng):
    sigs = rng.integers(0, 6, (45, 12)).astype(np.int32)
    qs = rng.integers(0, 6, (3, 12)).astype(np.int32)
    stacked = np.concatenate([sigs, np.full((3, 12), -1, np.int32)]).reshape(4, 12, 12)
    for method in METHODS:
        params = SearchParams(k=6, max_count=12, method=TopKMethod(method))
        jparams = JSearchParams(k=6, max_count=12, method=JMethod(method), use_kernel=False)
        got = multiload.multiload_search(torch.from_numpy(stacked), torch.from_numpy(qs),
                                         params, match.match_eq, n_objects=45)
        _same(got, jmultiload.multiload_search(jnp.asarray(stacked), jnp.asarray(qs), jparams,
                                               jmatch.match_eq, n_objects=45))


# ---------------------------------------------------------------------------
# Every engine, both forms, all three methods
# ---------------------------------------------------------------------------

LAYOUTS = [(Engine.EQ, "wide"), (Engine.RANGE, "wide"), (Engine.MINSUM, "wide"),
           (Engine.IP, "wide"), (Engine.COSINE, "wide"), (Engine.COSINE, "packed"),
           (Engine.TANIMOTO, "wide"), (Engine.TANIMOTO, "packed")]
SEG_ROWS = [23, 61, 4, 40]                       # uneven adds, one below k


def _raw(engine, n, q, seed):
    """The engine's registry example (COSINE at V = 45, a ragged last word)."""
    rng = np.random.default_rng(seed)
    if engine is Engine.COSINE:
        return (rng.integers(-3, 4, (n, 45)).astype(np.float32),
                rng.integers(-3, 4, (q, 45)).astype(np.float32), None)
    return engines.get(engine).example(rng, n, q)


@pytest.mark.parametrize("engine,layout", LAYOUTS, ids=lambda x: getattr(x, "value", x))
@pytest.mark.parametrize("method", METHODS)
def test_every_engine_both_forms_equal_reference(engine, layout, method):
    n = sum(SEG_ROWS)
    raw, queries, mc = _raw(engine, n, 5, seed=11)
    je = JEngine(engine.value)
    m, jm = TopKMethod(method), JMethod(method)
    # the scanned form: an even split of one index, padded (3 parts of 43)
    idx = GenieIndex.build(engine, raw, max_count=mc, signature_layout=layout, device="cpu")
    jidx = JGenieIndex.build(je, raw, max_count=mc, use_kernel=False, signature_layout=layout)
    _same(idx.search_multiload(queries, k=9, n_parts=3, method=m),
          jidx.search_multiload(queries, k=9, n_parts=3, method=jm))
    # the host loop: uneven segments, then one compaction
    seg = SegmentedIndex(engine, max_count=mc, signature_layout=layout, device="cpu")
    jseg = JSegmentedIndex(je, max_count=mc, use_kernel=False, signature_layout=layout)
    start = 0
    for r in SEG_ROWS:
        seg.add(raw[start:start + r])
        jseg.add(raw[start:start + r])
        start += r
    for _ in range(2):
        want = jseg.search_multiload(queries, k=9, method=jm)
        _same(seg.search_multiload(queries, k=9, method=m), want)
        _same(seg.search(queries, k=9, method=m), want)
        seg.compact(max_segments=2)
        jseg.compact(max_segments=2)
        assert seg.segment_rows == jseg.segment_rows


# ---------------------------------------------------------------------------
# The plan: describe(), gating, error texts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_loop,rows,n_objects", [(False, (40, 40, 40), 113),
                                                      (True, (40, 3, 200), 243),
                                                      (True, tuple(range(1, 41)), None)])
@pytest.mark.parametrize("signature_layout", ["wide", "packed"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_describe_equals_reference_but_fused_hist(host_loop, rows, n_objects,
                                                  signature_layout, use_kernel):
    kw = dict(layout="multiload", part_rows=rows, n_objects=n_objects, candidate_cap=33,
              use_kernel=use_kernel, signature_layout=signature_layout, host_loop=host_loop)
    plan = plan_search(Engine.COSINE, 12, 45, method=TopKMethod.SPQ, **kw)
    got = plan.describe()
    want = jplan.plan_search(JEngine.COSINE, 12, 45, method=JMethod.SPQ, **kw).describe()
    assert set(got) <= set(want)
    assert {key: v for key, v in got.items() if key != "fused_hist"} == \
        {key: want[key] for key in got if key != "fused_hist"}
    assert set(want) - set(got) == set()
    assert got["merge"] == ("ragged-buffer" if host_loop else "incremental-pairwise")
    assert got["host_loop"] is host_loop and plan.fused_match is None
    # the one difference: the port runs the histogram kernel on MULTILOAD
    assert got["fused_hist"] is use_kernel and want["fused_hist"] is False


def test_even_split_plans_like_the_reference():
    for n_parts, n_objects in ((1, 10), (3, 10), (7, 50), (50, 7)):
        got = plan_search(Engine.EQ, 5, 12, layout=Layout.MULTILOAD, n_parts=n_parts,
                          n_objects=n_objects)
        want = jplan.plan_search(JEngine.EQ, 5, 12, layout=jplan.Layout.MULTILOAD,
                                 n_parts=n_parts, n_objects=n_objects)
        assert got.part_rows == want.part_rows and got.pad_rows == want.pad_rows
        assert got.merge_strategy() == want.merge_strategy() == "incremental-pairwise"


def test_multiload_errors_match_the_reference(rng):
    for kw, text in ((dict(n_parts=0, n_objects=10), "n_parts must be >= 1"),
                     (dict(n_parts=3), "an even multiload split needs n_objects"),
                     (dict(part_rows=(4, 5)), "scanned multiload layout requires uniform"),
                     (dict(), "requires part_rows")):
        for planner, engine, layout in ((plan_search, Engine.EQ, Layout.MULTILOAD),
                                        (jplan.plan_search, JEngine.EQ,
                                         jplan.Layout.MULTILOAD)):
            with pytest.raises(ValueError, match=text):
                planner(engine, 5, 12, layout=layout, **kw)
    # ragged parts are fine in the host loop
    plan = plan_search(Engine.EQ, 5, 12, layout=Layout.MULTILOAD, part_rows=(4, 5),
                       host_loop=True)
    assert plan.host_loop and plan.n_parts == 2
    seg = SegmentedIndex(Engine.EQ, device="cpu")
    jseg = JSegmentedIndex(JEngine.EQ)
    data = rng.integers(0, 4, (20, 8)).astype(np.int32)
    seg.add(data)
    jseg.add(data)
    # routed multiload is ported: ROUTED equals the reference's ROUTED
    q = rng.integers(0, 4, (2, 8)).astype(np.int32)
    _same(seg.search_multiload(q, k=3, routing="routed"),
          jseg.search_multiload(q, k=3, routing="routed"))
    with pytest.raises(ValueError, match="empty SegmentedIndex"):
        SegmentedIndex(Engine.EQ, device="cpu").search_multiload(np.zeros((1, 8), np.int32), 3)
    with pytest.raises(ValueError, match="pad_and_stack needs a MULTILOAD plan"):
        tplan.pad_and_stack(plan_search(Engine.EQ, 5, 12), torch.zeros((4, 12)))
    with pytest.raises(ValueError, match="plan says 5"):
        tplan.execute(plan, [torch.zeros((4, 12), dtype=torch.int32)] * 2,
                      torch.zeros((1, 12), dtype=torch.int32))


def test_host_loop_refuses_a_part_on_another_device_than_cpu_queries(rng):
    """CPU queries never pull a part off another device: a part that does not
    lie in host memory raises, naming both devices (a `meta` tensor stands in
    for a part on a card here), and nothing is moved or searched on the CPU
    in its place."""
    params = SearchParams(k=3, max_count=8)
    host = torch.from_numpy(rng.integers(0, 4, (6, 8)).astype(np.int32))
    elsewhere = torch.empty((5, 8), dtype=torch.int32, device="meta")
    queries = torch.from_numpy(rng.integers(0, 4, (2, 8)).astype(np.int32))
    for parts in ([host, elsewhere], [elsewhere, host]):
        with pytest.raises(ValueError, match="a part lies on meta and the queries on cpu"):
            multiload.multiload_search_host(parts, queries, params, Engine.EQ)
    # host parts, numpy or tensors, are searched where the queries lie
    got = multiload.multiload_search_host([host, host.numpy()], queries, params, Engine.EQ)
    assert got.ids.device == CPU
