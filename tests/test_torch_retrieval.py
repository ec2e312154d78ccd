"""The slice as a whole: the port's RetrievalService against the JAX
package's, hashing with carried-over parameters, through several adds past
`max_segments` (so compaction runs) and searches by all three methods.

From the signatures on everything is integer and must be equal.  The float
step (the E2LSH projection) is held in the two forms tests/test_torch_lsh.py
states: (i) dyadic parameters and integer coordinates, where float32 sums
are exact in any order, so signatures, ids, counts and thresholds are equal;
(ii) Gaussian parameters as the services draw them, where a signature slot
may differ only within 1e-4 of a bucket boundary (float64 evaluation) and in
at most 1e-3 of all slots."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lsh import e2lsh as je2lsh
from repro.core.types import TopKMethod as JMethod
from repro.serve.retrieval import RetrievalService as JRetrievalService
from repro_torch.core import TopKMethod
from repro_torch.core.lsh import e2lsh
from repro_torch.serve import RetrievalService

M, DIM = 32, 16
BATCHES = [40, 7, 95, 3, 60, 21, 33, 12]      # 8 adds, max_segments=4: two compactions


def _carry(jparams, **kw):
    params = e2lsh.params_from_numpy(np.asarray(jparams.a), np.asarray(jparams.b),
                                     np.asarray(jparams.seeds), jparams.w, jparams.p,
                                     jparams.n_buckets, device="cpu")
    return RetrievalService(m_override=M, max_segments=4, device="cpu", params=params, **kw)


def _fill(svc, emb):
    start = 0
    for rows in BATCHES:
        svc.add([f"doc{i}" for i in range(start, start + rows)], embeddings=emb[start:start + rows])
        start += rows


def _dyadic_pair(rng, mesh=None, jmesh=None):
    a = rng.integers(-128, 129, size=(M, DIM)).astype(np.float32) / 64.0
    b = rng.integers(0, 256, size=(M,)).astype(np.float32) / 64.0
    seeds = rng.integers(0, 2**31 - 1, size=M).astype(np.uint32)
    jparams = je2lsh.E2LSHParams(a=jnp.asarray(a), b=jnp.asarray(b), seeds=jnp.asarray(seeds),
                                 w=4.0, p=2, n_buckets=8192)
    jsvc = JRetrievalService(embed_fn=np.asarray, m_override=M, max_segments=4, mesh=jmesh)
    # test code only: install the parameters before the first add()
    jsvc._params, jsvc._dim = jparams, DIM
    return _carry(jparams, mesh=mesh), jsvc


@pytest.mark.parametrize("use_kernel", [True, False])
def test_dyadic_round_trip_is_equal(use_kernel, rng):
    """Form (i)."""
    svc, jsvc = _dyadic_pair(rng)
    svc.use_kernel = use_kernel
    emb = rng.integers(-6, 7, size=(sum(BATCHES), DIM)).astype(np.float32)
    _fill(svc, emb)
    _fill(jsvc, emb)
    assert len(svc) == len(jsvc) == sum(BATCHES)
    a, b = svc.index_stats, jsvc.index_stats
    assert a.segment_rows == b.segment_rows and a.compaction_count == b.compaction_count == 2
    assert a.n_objects == b.n_objects and a.n_segments == b.n_segments
    for seg, jseg in zip(svc._index.segments, jsvc._index.segments):
        assert np.array_equal(seg.data.numpy(), np.asarray(jseg.data))
    queries = np.concatenate([emb[::29], emb[:3] + 1.0])
    for method in ("cpq", "spq", "sort"):
        for k in (1, 10, 50):
            res, sims = svc.search(None, k=k, embeddings=queries, method=TopKMethod(method))
            jres, jsims = jsvc.search(None, k=k, embeddings=queries, method=JMethod(method))
            assert np.array_equal(res.ids.numpy(), np.asarray(jres.ids))
            assert np.array_equal(res.counts.numpy(), np.asarray(jres.counts))
            assert np.array_equal(res.threshold.numpy(), np.asarray(jres.threshold))
            assert np.array_equal(sims, jsims)
    res, _ = svc.search(None, k=5, embeddings=torch.from_numpy(queries), candidate_cap=5)
    jres, _ = jsvc.search(None, k=5, embeddings=queries, candidate_cap=5)
    assert np.array_equal(res.ids.numpy(), np.asarray(jres.ids))
    assert svc.items_for(res.ids) == jsvc.items_for(np.asarray(jres.ids))
    assert svc.items_for(np.array([[0, -1]])) == [["doc0", None]]
    assert svc.batch_compat_key(5, TopKMethod.CPQ, "none")[5] == 8


def test_gaussian_round_trip_differs_only_at_bucket_boundaries(rng):
    """Form (ii): the reference service draws its own parameters."""
    jsvc = JRetrievalService(embed_fn=np.asarray, m_override=M, max_segments=4)
    emb = rng.standard_normal((sum(BATCHES), DIM)).astype(np.float32) * 2.0
    _fill(jsvc, emb)
    svc = _carry(jsvc._params)
    _fill(svc, emb)
    got = torch.cat([s.data for s in svc._index.segments]).numpy()
    want = np.concatenate([np.asarray(s.data) for s in jsvc._index.segments])
    differ = got != want
    assert differ.mean() <= 1e-3
    exact = (emb.astype(np.float64) @ np.asarray(jsvc._params.a, np.float64).T
             + np.asarray(jsvc._params.b, np.float64)) / 4.0
    assert np.all((np.abs(exact - np.round(exact)) < 1e-4)[differ])
    # unperturbed corpus points retrieve themselves on both sides
    pick = np.arange(0, sum(BATCHES), 13)
    res, sims = svc.search(None, k=5, embeddings=emb[pick])
    jres, _ = jsvc.search(None, k=5, embeddings=emb[pick])
    assert np.array_equal(res.ids[:, 0].numpy(), pick)
    assert np.array_equal(np.asarray(jres.ids)[:, 0], pick)
    assert np.all(sims[:, 0] == 1.0)
    if not differ.any():                       # equal signatures: equal results
        assert np.array_equal(res.ids.numpy(), np.asarray(jres.ids))
        assert np.array_equal(res.counts.numpy(), np.asarray(jres.counts))


def test_own_parameters_come_from_the_seed(rng):
    emb = rng.standard_normal((50, DIM)).astype(np.float32)
    sigs = []
    for seed in (0, 0, 1):
        svc = RetrievalService(embed_fn=lambda items: emb[:len(items)], m_override=M,
                               seed=seed, device="cpu")
        svc.add(range(50))                      # through embed_fn
        sigs.append(svc._index.segments[0].data)
    assert torch.equal(sigs[0], sigs[1]) and not torch.equal(sigs[0], sigs[2])
    assert sigs[0].dtype == torch.int32 and int(sigs[0].min()) >= 0 and int(sigs[0].max()) < 8192


def _empty(cls, kw):
    return cls(embed_fn=np.asarray, m_override=8, **kw)


def _filled(cls, kw):
    svc = _empty(cls, kw)
    svc.add(["a", "b", "c"], embeddings=np.eye(3, 4, dtype=np.float32))
    return svc


VALIDATION = {
    "embeddings-not-2d": (_empty, lambda s: s.add(["a"], embeddings=np.zeros(4, np.float32))),
    "row-count-mismatch": (_empty, lambda s: s.add(["a", "b"], embeddings=np.zeros((3, 4), np.float32))),
    "dim-mismatch-add": (_filled, lambda s: s.add(["d"], embeddings=np.zeros((1, 5), np.float32))),
    "dim-mismatch-search": (_filled, lambda s: s.search(None, embeddings=np.zeros((1, 5), np.float32))),
    "empty-add": (_empty, lambda s: s.add([], embeddings=np.zeros((0, 4), np.float32))),
    "empty-add-iterator": (_empty, lambda s: s.add(iter(()))),
    "index-stats-before-add": (_empty, lambda s: s.index_stats),
    "search-before-add": (_empty, lambda s: s.search(["q"], embeddings=np.zeros((1, 4), np.float32))),
    "empty-queries": (_filled, lambda s: s.search([], k=2)),
    "empty-query-embeddings": (_filled, lambda s: s.search(None, embeddings=np.zeros((0, 4), np.float32))),
    "query-rows-mismatch": (_filled, lambda s: s.search(["q"], embeddings=np.zeros((2, 4), np.float32))),
    "items-for-too-large": (_filled, lambda s: s.items_for(np.array([[0, 3]]))),
    "items-for-below-minus-one": (_filled, lambda s: s.items_for(np.array([[-2]]))),
    "items-for-empty-corpus": (_empty, lambda s: s.items_for(np.array([[0]]))),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors_equal_reference(case):
    make, act = VALIDATION[case]
    with pytest.raises(ValueError) as ours:
        act(make(RetrievalService, {"device": "cpu"}))
    with pytest.raises(ValueError) as theirs:
        act(make(JRetrievalService, {}))
    assert type(ours.value) is type(theirs.value)
    assert str(ours.value) == str(theirs.value)


def test_constructor_validation():
    with pytest.raises(ValueError, match="max_segments must be >= 1"):
        RetrievalService(m_override=8, max_segments=0, device="cpu")
    with pytest.raises(ValueError, match="no packed signature format"):
        RetrievalService(m_override=8, signature_layout="packed", device="cpu")
    with pytest.raises(KeyError, match="unknown LSH scheme"):
        RetrievalService(m_override=8, scheme="no-such-scheme", device="cpu")
    with pytest.raises(ValueError, match="no embed_fn"):
        RetrievalService(m_override=8, device="cpu").add(["a"])
    with pytest.raises(TypeError, match="mesh= takes a DeviceMesh"):
        RetrievalService(m_override=8, device="cpu", mesh=object())


# routed search (ROADMAP queue 1 item 6), the autotuner (item 8) and sharded
# serving (item 9) raised here until they were ported
PORTED = {"routing": dict(routing="routed"),
          "nprobe": dict(routing="routed_verified", nprobe=2),
          "autotune": {}, "tune": {}, "mesh": {}}


def _tuned_caches(n: int):
    """An autotune entry for the corpus's shape -- floor tiles and the host
    loop in place of the SEGMENTED merge -- in a cache of each package."""
    from repro.core import autotune as jautotune
    from repro_torch.core import autotune

    caches = []
    for lib, kw in ((autotune, {"device": "cpu"}), (jautotune, {})):
        cache = lib.AutotuneCache(**kw)
        cache.put(lib.TunedEntry(
            engine="eq", signature_layout="wide", n_bucket=lib.shape_bucket(n),
            w_bucket=lib.shape_bucket(M), tile_overrides=(("tile_n", 128), ("tile_q", 8)),
            layout="multiload_host", speedup=1.5))
        caches.append(cache)
    return caches


@pytest.mark.parametrize("case", ["mesh", "autotune", "tune", "routing", "nprobe"])
def test_unported_parameters_raise_and_name_their_roadmap_item(case, rng):
    """Parameters that once raised NotImplementedError naming their ROADMAP
    item search as the reference does now: the routing keywords, the
    autotuner (`autotune=` with a tuned entry that switches the layout,
    `tune()`) and sharded serving (`mesh=`: a one-rank gloo mesh against
    the reference's one-device mesh, through two compactions)."""
    mesh = {}
    if case == "mesh":
        from repro.launch import mesh as jmesh
        from repro_torch.launch import mesh as tmesh

        mesh = dict(mesh=tmesh.make_mesh((1,), ("data",), device="cpu"),
                    jmesh=jmesh.make_mesh((1,), ("data",)))
    svc, jsvc = _dyadic_pair(rng, **mesh)
    emb = rng.integers(-6, 7, size=(sum(BATCHES), DIM)).astype(np.float32)
    _fill(svc, emb)
    _fill(jsvc, emb)
    queries = np.concatenate([emb[::29], emb[:3] + 1.0])
    if case == "autotune":
        svc.autotune, jsvc.autotune = _tuned_caches(sum(BATCHES))
    if case == "tune":
        entry = svc.tune(None, k=7, embeddings=queries, budget=2, repeats=1, save=False)
        assert entry.speedup >= 1.0 and svc.autotune.lookup("eq", "wide", len(svc), M) == entry
    res, sims = svc.search(None, k=7, embeddings=queries, **PORTED[case])
    jres, jsims = jsvc.search(None, k=7, embeddings=queries, **PORTED[case])
    assert np.array_equal(res.ids.numpy(), np.asarray(jres.ids))
    assert np.array_equal(res.counts.numpy(), np.asarray(jres.counts))
    assert np.array_equal(res.threshold.numpy(), np.asarray(jres.threshold))
    assert np.array_equal(sims, jsims)
    if case == "mesh":                         # served from the sharded placement
        assert svc._placed is not None and svc._placed[2] == len(svc) == len(jsvc)
        key, jkey = svc.batch_compat_key(7, "cpq", "none"), jsvc.batch_compat_key(7, "cpq", "none")
        assert [getattr(x, "value", x) for x in key] == [getattr(x, "value", x) for x in jkey]
        assert key[1].value == "distributed"


def test_load_params_rules(rng):
    params = e2lsh.make(torch.Generator().manual_seed(0), d=4, m=8, w=4.0, device="cpu")
    svc = RetrievalService(m_override=8, device="cpu")
    svc.load_params(params)
    with pytest.raises(ValueError, match="already fixed"):
        svc.load_params(params)
    with pytest.raises(ValueError, match="embedding dim 5 != dim 4"):
        svc.add(["a"], embeddings=np.zeros((1, 5), np.float32))
    with pytest.raises(ValueError, match="m_override=8"):
        RetrievalService(m_override=9, device="cpu", params=params)
    filled = _filled(RetrievalService, {"device": "cpu"})
    with pytest.raises(ValueError, match="already fixed"):
        filled.load_params(params)
