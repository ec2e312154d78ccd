"""The port's serving front-end (`repro_torch.serve.frontend`, `scheduler`,
`metrics`): tests/test_frontend.py (its mesh case on a one-rank gloo mesh
here, and with the placement cache in tests/test_torch_distributed.py).

The load-bearing invariant: a coalesced dispatch stacks the query rows of
several requests and runs at the shared bucketed k; each request's result is
a row-slice and k-prefix of it, and equals the serial per-request search --
here the JAX package's serial search on the same numpy inputs, ids, counts,
threshold and sims, no tolerance.  'routed_verified' keeps the guarantee;
plain 'routed' is batch-dependent by contract and stays out of the matrix.

Every wait on a future, a drain or the loop's close has a timeout of 30 s or
less, and every test closes its front-end in a `finally`: a hung dispatch
thread fails its test instead of stalling the suite."""
from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.core import engines as jengines
from repro.core.segments import SegmentedIndex as JSegmentedIndex
from repro.core.types import Engine as JEngine
from repro.serve import IndexService as JIndexService
from repro.serve import RetrievalService as JRetrievalService
from repro.serve.metrics import FrontendMetrics as JFrontendMetrics
from repro.serve.metrics import percentile as jpercentile
from repro_torch.core import Engine, SegmentedIndex, TopKMethod
from repro_torch.core import plan as tplan
from repro_torch.core.lsh import e2lsh
from repro_torch.core.routing import Routing
from repro_torch.kernels import build, common
from repro_torch.serve import (FrontendMetrics, IndexService, Overloaded, RetrievalService,
                               ServingFrontend)
from repro_torch.serve import frontend as tfrontend
from repro_torch.serve.metrics import percentile
from repro_torch.serve.scheduler import Request, RequestQueue, coalesce

ENGINES = ["eq", "range", "minsum", "ip", "tanimoto", "cosine"]
SEG_ROWS = (40, 25, 17)
WAIT = 30                      # seconds: every wait in this file is bounded


def _jax_e2lsh(a, b, seeds):
    import jax.numpy as jnp

    from repro.core.lsh.e2lsh import E2LSHParams

    return E2LSHParams(a=jnp.asarray(a), b=jnp.asarray(b), seeds=jnp.asarray(seeds), w=4.0, p=2,
                       n_buckets=8192)


def _example(engine: str, n: int, q: int, seed: int = 0):
    return jengines.get(JEngine(engine)).example(np.random.default_rng(seed), n, q)


def _build_pair(engine: str, seed: int = 0):
    """A 3-uneven-segment index in each package plus a query batch."""
    data, queries, max_count = _example(engine, sum(SEG_ROWS), 16, seed)
    idx = SegmentedIndex(Engine(engine), max_count=max_count, device="cpu")
    jidx = JSegmentedIndex(engine=JEngine(engine), max_count=max_count, use_kernel=False)
    lo = 0
    for rows in SEG_ROWS:
        idx.add(data[lo:lo + rows])
        jidx.add(data[lo:lo + rows])
        lo += rows
    return idx, jidx, queries


def _stackable(engine: str, queries):
    """Queries as one array with axis 0 = query rows (RANGE's (lo, hi) pair
    stacks to [q, 2, d]), plus the adapter back to the engine's form."""
    if engine == "range":
        return (np.stack([np.asarray(queries[0]), np.asarray(queries[1])], axis=1),
                lambda a: (a[:, 0, :], a[:, 1, :]))
    return np.asarray(queries), None


def _assert_result_equal(ref, refsims, got, gotsims, ctx=""):
    assert isinstance(got.ids, np.ndarray) and isinstance(got.counts, np.ndarray), ctx
    assert np.array_equal(np.asarray(ref.ids), got.ids), ctx
    assert np.array_equal(np.asarray(ref.counts), got.counts), ctx
    assert np.array_equal(np.asarray(ref.threshold), got.threshold), ctx
    if refsims is None:
        assert gotsims is None, ctx
    else:
        assert np.array_equal(np.asarray(refsims), np.asarray(gotsims)), ctx


def _serial(svc, queries, k, **kw):
    """A serial search of the port's service, as numpy."""
    res, sims = svc.search(None, k=k, embeddings=queries, **kw)
    return res.ids.numpy(), res.counts.numpy(), res.threshold.numpy(), sims


# ---------------------------------------------------------------------------
# scheduler: coalescing + admission
# ---------------------------------------------------------------------------

def _req(seq, tenant, q, key, k=4, embeddings=None):
    return Request(seq=seq, tenant=tenant,
                   embeddings=np.zeros((q, 3)) if embeddings is None else embeddings,
                   k=k, dispatch_k=tplan.k_bucket(k), method=TopKMethod.CPQ,
                   routing=Routing.NONE, nprobe=None, candidate_cap=None,
                   key=(tenant, key), future=Future(), submitted_at=time.perf_counter())


def test_coalesce_groups_by_key_and_chunks_by_max_batch():
    reqs = [_req(0, "a", 4, "x"), _req(1, "b", 4, "x"), _req(2, "a", 4, "x"),
            _req(3, "a", 4, "y"), _req(4, "a", 9, "x")]
    groups = coalesce(reqs, max_batch=8)
    # (a, x) chunks into [0, 2] then [4] (9 rows alone exceeds the cap but a
    # single request is never split); (b, x) and (a, y) are their own groups
    assert [[r.seq for r in g] for g in groups] == [[0, 2], [1], [3], [4]]
    assert all(len({r.key for r in g}) == 1 for g in groups)
    with pytest.raises(ValueError, match="max_batch must be >= 1"):
        coalesce(reqs, max_batch=0)


def test_request_queue_admission_and_drain():
    q = RequestQueue(max_queue=2, max_batch=64, max_wait_s=0.0)
    q.offer(_req(0, "a", 1, "x"))
    q.offer(_req(1, "a", 1, "x"))
    with pytest.raises(Overloaded) as ei:
        q.offer(_req(2, "a", 1, "x"))
    assert ei.value.queue_depth == 2 and ei.value.max_queue == 2
    assert ei.value.tenant == "a"
    stop = threading.Event()
    groups = q.take(stop)
    assert [[r.seq for r in g] for g in groups] == [[0, 1]]
    assert q.depth() == 0
    stop.set()
    assert q.take(stop) is None     # stopped + drained -> exit signal


def test_stacked_rows_are_one_concatenation_with_row_zero_pads():
    """numpy requests stack as numpy; a group holding a tensor stacks as
    tensors on that tensor's device; the pad rows copy row 0."""
    a, b = np.arange(6, dtype=np.int32).reshape(2, 3), np.full((1, 3), 9, np.int32)
    group = [_req(0, "t", 2, "x", embeddings=a), _req(1, "t", 1, "x", embeddings=b)]
    got = tfrontend._stack_rows(group, 1)
    assert isinstance(got, np.ndarray) and got.tolist() == [[0, 1, 2], [3, 4, 5],
                                                            [9, 9, 9], [0, 1, 2]]
    group[1] = _req(1, "t", 1, "x", embeddings=torch.from_numpy(b))
    got = tfrontend._stack_rows(group, 1)
    assert isinstance(got, torch.Tensor) and got.tolist() == [[0, 1, 2], [3, 4, 5],
                                                              [9, 9, 9], [0, 1, 2]]
    assert tfrontend._stack_rows(group[:1], 0) is a


# ---------------------------------------------------------------------------
# the bit-exactness matrix: 6 engines x routing on/off, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("routing", [Routing.NONE, Routing.ROUTED_VERIFIED],
                         ids=["unrouted", "routed"])
def test_coalesced_parity_matrix(engine, routing):
    """Coalesced dispatch of the port == the reference's serial search."""
    idx, jidx, queries = _build_pair(engine)
    stacked, adapter = _stackable(engine, queries)
    svc = IndexService(index=idx, query_adapter=adapter)
    jsvc = JIndexService(index=jidx, query_adapter=adapter)
    nprobe = 1 if routing is not Routing.NONE else None
    # mixed k across one bucket (3, 4 -> 4) plus a second bucket (10 -> 16),
    # overlapping query slices, submitted before the loop starts so the first
    # take() drains and coalesces them all; one request sends a tensor
    slices = [(0, 6, 3), (6, 16, 4), (2, 10, 10), (8, 16, 3)]
    fe = ServingFrontend(max_wait_us=0, start=False)
    try:
        fe.register(engine, svc)
        futs = [fe.submit(engine, None, k=k,
                          embeddings=torch.from_numpy(stacked[lo:hi]) if i == 1
                          else stacked[lo:hi], routing=routing, nprobe=nprobe)
                for i, (lo, hi, k) in enumerate(slices)]
        fe.start()
        results = [f.result(timeout=WAIT) for f in futs]
    finally:
        fe.close(timeout=WAIT)
    st = fe.stats()
    assert st["dispatches"] < len(slices) and st["coalesce_ratio"] > 1.0
    for (lo, hi, k), (got, gotsims) in zip(slices, results):
        ref, refsims = jsvc.search(None, k=k, embeddings=stacked[lo:hi],
                                   routing=routing.value, nprobe=nprobe)
        _assert_result_equal(ref, refsims, got, gotsims,
                             ctx=f"{engine} k={k} routing={routing.value}")


def test_mixed_tenants_concurrent_submitters():
    """All six engines as tenants of ONE front-end, submitted from four
    client threads: every future resolves to its serial result."""
    tenants = {}
    for engine in ENGINES:
        idx, _, queries = _build_pair(engine, seed=3)
        stacked, adapter = _stackable(engine, queries)
        tenants[engine] = (IndexService(index=idx, query_adapter=adapter), stacked)
    fe = ServingFrontend(max_wait_us=5000)
    try:
        for name, (svc, _) in tenants.items():
            fe.register(name, svc)
        futs: list[tuple] = []
        flock = threading.Lock()

        def client(worker: int):
            for i, (name, (_, stacked)) in enumerate(tenants.items()):
                lo, k = (worker + i) % 8, 3 + ((worker + i) % 3)
                f = fe.submit(name, None, k=k, embeddings=stacked[lo:lo + 5])
                with flock:
                    futs.append((name, lo, k, f))

        threads = [threading.Thread(target=client, args=(w,)) for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        resolved = [(name, lo, k, f.result(timeout=WAIT)) for name, lo, k, f in futs]
        st = fe.stats()
    finally:
        fe.close(timeout=WAIT)
    assert len(resolved) == 4 * len(ENGINES)
    for name, lo, k, (got, gotsims) in resolved:
        svc, stacked = tenants[name]
        ids, counts, thr, _ = _serial(svc, stacked[lo:lo + 5], k)
        assert np.array_equal(got.ids, ids) and np.array_equal(got.counts, counts), name
        assert np.array_equal(got.threshold, thr) and gotsims is None
    assert set(st["tenants"]) == set(ENGINES)


def test_concurrent_stress_keeps_every_request_exact():
    """More submitting threads than cores, with a short switch interval: every
    request equals its serial search and the pending counts return to 0 (a
    lost update in the bookkeeping would leave one behind)."""
    idx, _, queries = _build_pair("eq", seed=5)
    svc = IndexService(index=idx)
    stacked = np.asarray(queries)
    fe = ServingFrontend(max_wait_us=200, max_batch=32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        fe.register("t", svc)
        out, lock = [], threading.Lock()

        def client(worker: int):
            for i in range(6):
                lo, k = (worker * 3 + i) % 12, 1 + (worker + i) % 7
                f = fe.submit("t", None, k=k, embeddings=stacked[lo:lo + 4])
                with lock:
                    out.append((lo, k, f))

        threads = [threading.Thread(target=client, args=(w,)) for w in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        got = [(lo, k, f.result(timeout=WAIT)[0]) for lo, k, f in out]
    finally:
        sys.setswitchinterval(interval)
        fe.close(timeout=WAIT)
    assert len(got) == 24 * 6 and fe.stats()["pending_requests"] == 0
    for lo, k, res in got:
        ids, counts, thr, _ = _serial(svc, stacked[lo:lo + 4], k)
        assert np.array_equal(res.ids, ids) and np.array_equal(res.counts, counts)
        assert np.array_equal(res.threshold, thr)


def _carried_service(seed: int, scheme: str, m: int, dim: int, **kw):
    """A port RetrievalService and a reference one hashing with the same
    E2LSH / simhash parameters, dyadic so that the float32 products of
    integer embeddings are exact in any order and the signatures equal."""
    import jax.numpy as jnp

    from repro.core.lsh import e2lsh as je2lsh, simhash as jsimhash
    from repro_torch.core.lsh import simhash

    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 129, size=(m, dim)).astype(np.float32) / 64.0
    if scheme == "e2lsh":
        b = rng.integers(0, 256, size=(m,)).astype(np.float32) / 64.0
        seeds = rng.integers(0, 2**31 - 1, size=m).astype(np.uint32)
        jparams = je2lsh.E2LSHParams(a=jnp.asarray(a), b=jnp.asarray(b),
                                     seeds=jnp.asarray(seeds), w=4.0, p=2, n_buckets=8192)
        params = e2lsh.params_from_numpy(a, b, seeds, 4.0, 2, 8192, device="cpu")
    else:
        jparams = jsimhash.SimHashParams(v=jnp.asarray(a))
        params = simhash.params_from_numpy(a, device="cpu")
    jsvc = JRetrievalService(embed_fn=np.asarray, scheme=scheme, m_override=m, **kw)
    # test code only: install the parameters before the first add()
    jsvc._params, jsvc._dim = jparams, dim
    svc = RetrievalService(embed_fn=np.asarray, scheme=scheme, m_override=m, device="cpu",
                           params=params, **kw)
    return svc, jsvc


def test_retrieval_service_tenants_with_sims():
    """RetrievalService tenants (embed -> hash -> search -> MLE): coalesced
    results and sims equal the reference service's serial search."""
    rng = np.random.default_rng(0)
    pts = {name: rng.integers(-6, 7, (256, 8)).astype(np.float32)
           for name in ("acme", "globex")}
    pairs = {"acme": _carried_service(1, "e2lsh", 16, 8, max_segments=4),
             "globex": _carried_service(2, "simhash", 32, 8)}
    fe = ServingFrontend(max_wait_us=200_000, start=False)
    try:
        for name, (svc, jsvc) in pairs.items():
            fe.register(name, svc)
            for lo in (0, 128):
                fe.add(name, list(range(lo, lo + 128)), embeddings=pts[name][lo:lo + 128])
                jsvc.add(list(range(lo, lo + 128)), embeddings=pts[name][lo:lo + 128])
        reqs = [("acme", 0, 5), ("globex", 3, 5), ("acme", 7, 8), ("globex", 1, 3),
                ("acme", 2, 5)]
        futs = [fe.submit(name, None, k=k, embeddings=pts[name][lo:lo + 4] + 1)
                for name, lo, k in reqs]
        fe.start()
        results = [f.result(timeout=WAIT) for f in futs]
        st = fe.stats()
    finally:
        fe.close(timeout=WAIT)
    assert st["dispatches"] < len(reqs)    # per-tenant coalescing
    for (name, lo, k), (got, gotsims) in zip(reqs, results):
        ref, refsims = pairs[name][1].search(None, k=k, embeddings=pts[name][lo:lo + 4] + 1)
        _assert_result_equal(ref, refsims, got, gotsims, ctx=f"{name} k={k}")
        assert gotsims.shape == (4, k)


# ---------------------------------------------------------------------------
# admission control, lifecycle, heartbeats
# ---------------------------------------------------------------------------

def _tiny_frontend(**kw) -> tuple[ServingFrontend, np.ndarray]:
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((64, 6)).astype(np.float32)
    fe = ServingFrontend(**kw)
    fe.create_tenant("t", embed_fn=np.asarray, m_override=8, device="cpu")
    fe.add("t", list(range(64)), embeddings=pts)
    return fe, pts


def test_overload_sheds_with_typed_error():
    fe, pts = _tiny_frontend(max_queue=2, max_wait_us=0, start=False)
    try:
        fe.submit("t", None, k=2, embeddings=pts[:1])
        fe.submit("t", None, k=2, embeddings=pts[:1])
        with pytest.raises(Overloaded) as ei:
            fe.submit("t", None, k=2, embeddings=pts[:1])
        assert ei.value.tenant == "t"
        assert fe.stats()["tenants"]["t"]["shed"] == 1
        assert fe.stats()["pending_requests"] == 2   # shed request not counted
        fe.start()
    finally:
        fe.close(timeout=WAIT)
    assert fe.stats()["pending_requests"] == 0       # close() drained the queue
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit("t", None, k=2, embeddings=pts[:1])


def test_drain_waits_then_removes_tenant():
    fe, pts = _tiny_frontend(max_wait_us=0)
    try:
        futs = [fe.submit("t", None, k=3, embeddings=pts[:2]) for _ in range(3)]
        fe.drain("t", timeout=WAIT)
        for f in futs:                       # admitted work completed, not dropped
            res, _ = f.result(timeout=0)
            assert res.ids.shape == (2, 3)
        assert fe.tenants() == []
        with pytest.raises(KeyError, match="unknown tenant"):
            fe.submit("t", None, k=3, embeddings=pts[:2])
        # the slot is recycled for a new tenant
        fe.create_tenant("t2", embed_fn=np.asarray, m_override=8, device="cpu")
        fe.add("t2", [0, 1], embeddings=pts[:2])
        res, _ = fe.search("t2", None, k=1, embeddings=pts[:1], timeout=WAIT)
        assert res.ids.shape == (1, 1)
    finally:
        fe.close(timeout=WAIT)


def test_heartbeat_idle_tenants_and_reap():
    fe, pts = _tiny_frontend(heartbeat_timeout_s=30.0)
    try:
        fe.search("t", None, k=2, embeddings=pts[:1], timeout=WAIT)
        now = time.time()
        assert fe.idle_tenants(now=now) == []
        assert fe.idle_tenants(now=now + 300) == ["t"]      # heartbeat expired
        assert fe.reap_idle(now=now + 300, timeout=WAIT) == ["t"]
        assert fe.tenants() == []
    finally:
        fe.close(timeout=WAIT)


def test_draining_tenant_rejects_submit_and_add():
    fe, pts = _tiny_frontend(max_wait_us=0)
    try:
        fe._tenants["t"].draining = True
        with pytest.raises(ValueError, match="draining"):
            fe.submit("t", None, k=2, embeddings=pts[:1])
        with pytest.raises(ValueError, match="draining"):
            fe.add("t", [99], embeddings=pts[:1])
    finally:
        fe.close(timeout=WAIT)


def test_registration_rules_and_the_unported_mesh():
    """Registration rules, and the shared mesh (once refused as unported): a
    tenant `create_tenant` builds serves sharded on it, as the reference's
    does on its one-device mesh."""
    from repro.launch import mesh as jmesh
    from repro.serve import ServingFrontend as JServingFrontend
    from repro_torch.launch import mesh as tmesh

    pts = np.random.default_rng(5).integers(-6, 7, size=(48, 6)).astype(np.float32)
    a = (np.arange(48, dtype=np.float32).reshape(8, 6) % 7 - 3) / 4
    b, seeds = np.arange(8, dtype=np.float32) / 4, np.arange(1, 9, dtype=np.uint32) * 977
    fe = ServingFrontend(mesh=tmesh.make_mesh((1,), ("data",), device="cpu"), max_wait_us=0)
    jfe = JServingFrontend(mesh=jmesh.make_mesh((1,), ("data",)), max_wait_us=0)
    try:
        svc = fe.create_tenant("t", embed_fn=np.asarray, m_override=8,
                               params=e2lsh.params_from_numpy(a, b, seeds, 4.0, 2, 8192,
                                                              device="cpu"))
        jsvc = jfe.create_tenant("t", embed_fn=np.asarray, m_override=8)
        jsvc._params, jsvc._dim = _jax_e2lsh(a, b, seeds), 6   # test code only
        assert svc.mesh is fe.mesh and svc.device.type == "cpu"
        for f, start, stop in ((fe, 0, 20), (fe, 20, 48), (jfe, 0, 20), (jfe, 20, 48)):
            f.add("t", list(range(start, stop)), embeddings=pts[start:stop])
        q = pts[::7] + 0.25
        res, sims = fe.search("t", None, k=4, embeddings=q, timeout=WAIT)
        jres, jsims = jfe.search("t", None, k=4, embeddings=q)
        _assert_result_equal(jres, jsims, res, sims)
        assert svc._placed is not None and svc._placed[2] == 48
    finally:
        fe.close(timeout=WAIT)
        jfe.close()
    fe = ServingFrontend(max_tenants=1, start=False)
    try:
        with pytest.raises(TypeError, match="must provide add"):
            fe.register("x", object())
        idx, _, _ = _build_pair("eq")
        fe.register("a", IndexService(index=idx))
        with pytest.raises(ValueError, match="already registered"):
            fe.register("a", IndexService(index=idx))
        with pytest.raises(Overloaded, match="tenant capacity exhausted"):
            fe.register("b", IndexService(index=idx))
    finally:
        fe.close(timeout=WAIT)


def test_a_failing_dispatch_resolves_its_futures_and_the_loop_lives_on():
    idx, _, queries = _build_pair("eq")
    svc = IndexService(index=idx)
    fe = ServingFrontend(max_wait_us=0)
    try:
        fe.register("t", svc)
        q = np.asarray(queries)
        broken = fe.submit("t", None, k=2, embeddings=q[:, :5])   # wrong width
        with pytest.raises(Exception) as direct:
            svc.search(None, k=2, embeddings=q[:, :5])
        with pytest.raises(type(direct.value)):                    # the search's own error
            broken.result(timeout=WAIT)
        res, _ = fe.search("t", None, k=2, embeddings=q[:2], timeout=WAIT)
        assert res.ids.shape == (2, 2) and fe.stats()["pending_requests"] == 0
    finally:
        fe.close(timeout=WAIT)


def test_empty_query_batch_raises_contract_error():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((32, 4)).astype(np.float32)
    svc = RetrievalService(embed_fn=np.asarray, m_override=8, device="cpu")
    svc.add(list(range(32)), embeddings=pts)
    for bad in (dict(queries=[]), dict(queries=iter(())),
                dict(queries=None, embeddings=np.empty((0, 4), np.float32))):
        with pytest.raises(ValueError, match="empty batch of queries"):
            svc.search(bad.get("queries"), k=3, embeddings=bad.get("embeddings"))
    fe = ServingFrontend(start=False)
    try:
        fe.register("t", svc)
        with pytest.raises(ValueError, match="empty batch of queries"):
            fe.submit("t", [], k=3)
    finally:
        fe.close(timeout=WAIT)
    idx, _, _ = _build_pair("eq")
    with pytest.raises(ValueError, match="empty batch of queries"):
        IndexService(index=idx).search(np.empty((0, 16), np.int32), k=3)
    with pytest.raises(ValueError, match="empty batch of queries"):
        IndexService(index=idx).search(torch.empty((0, 16), dtype=torch.int32), k=3)
    with pytest.raises(ValueError, match="query signatures must be"):
        IndexService(index=idx).search(np.zeros(16, np.int32), k=3)


# ---------------------------------------------------------------------------
# warm searches: no kernel build, the same launches per kernel
# ---------------------------------------------------------------------------

def test_warm_searches_build_nothing_and_repeat_their_launches(monkeypatch):
    """The reference counts jit traces (`trace_count`) to show that warm
    searches compile nothing.  The port has no tracer: a warm search makes no
    kernel build (`kernels/build.py`), the same launches per kernel as the
    search before it (`kernels/common.py`; none on the CPU, where the
    wrappers take their plain versions), and one part match a segment; a
    corpus grown by an equal-shaped segment adds one part match and no
    build.  tests/test_torch_gpu.py holds the same on the card."""
    builds = []
    monkeypatch.setattr(build, "build", lambda: builds.append(1))
    parts = []
    orig = tplan._part_topk
    monkeypatch.setattr(tplan, "_part_topk", lambda plan, data, *a, **kw: (
        parts.append(int(data.shape[0])) or orig(plan, data, *a, **kw)))
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((96, 6)).astype(np.float32)
    svc = RetrievalService(embed_fn=np.asarray, m_override=8, max_segments=8, device="cpu")
    svc.add(list(range(48)), embeddings=pts[:48])
    q = pts[:4] + 0.01
    svc.search(None, k=3, embeddings=q)                    # warm
    per_search = []
    for _ in range(3):
        common.reset_launch_counts()
        parts.clear()
        svc.search(None, k=3, embeddings=q)
        per_search.append((common.launch_counts(), list(parts)))
    assert per_search == [({}, [48])] * 3 and builds == []
    svc.add(list(range(48, 96)), embeddings=pts[48:])      # same 48-row shape
    parts.clear()
    svc.search(None, k=3, embeddings=q)
    assert parts == [48, 48] and builds == []


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank_equals_reference():
    xs = list(range(1, 101))
    for samples in ([], [5.0], xs, [3.5, 1.0, 2.25, 9.0]):
        for p in (0, 1, 50, 90, 99, 100):
            assert percentile(samples, p) == jpercentile(samples, p)
    assert percentile(xs, 50) == 51 and percentile(xs, 99) == 99
    with pytest.raises(ValueError):
        percentile(xs, 101)


def test_metrics_snapshot_schema_and_ratios_equal_reference():
    snaps = []
    for cls in (FrontendMetrics, JFrontendMetrics):
        m = cls(window=16)
        for _ in range(4):
            m.record_submit("a", 8)
        m.record_shed("a")
        m.record_dispatch(n_requests=4, n_queries=32)
        for lat in (0.010, 0.020, 0.030, 0.040):
            m.record_completion("a", lat)
        m.record_queue_depth(3)
        m.record_queue_depth(1)
        snaps.append(m.snapshot())
        m.forget_tenant("a")
        assert "a" not in m.snapshot()["tenants"]
    snap, jsnap = snaps
    assert snap == jsnap
    assert snap["coalesce_ratio"] == 4.0 and snap["batch_occupancy"] == 32.0
    assert snap["queue_depth"] == 1 and snap["queue_high_water"] == 3
    t = snap["tenants"]["a"]
    assert t["submitted"] == 4 and t["shed"] == 1 and t["completed"] == 4
    assert t["p50_ms"] == 30.0   # nearest rank of 4 samples
