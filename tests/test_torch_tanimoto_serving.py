"""The third slice as a whole: RetrievalService(scheme="minhash") in the WIDE
and PACKED signature layouts and RetrievalService(scheme="rbh") of the port
against the JAX package's services, with the parameters carried over by
`params_from_numpy`, for CPQ / SPQ / SORT through a compaction; and the
planner's fused gating for TANIMOTO.

minhash hashing is integer end to end, so Gaussian embeddings give equal
signatures; rbh is held on dyadic parameters (power-of-two pitches, shifts in
multiples of 1/64) and integer embeddings, where its float32 cell is exact.
PACKED plans on the kernel path take the fused match -> count -> per-tile
top-k kernel (on the CPU its plain version).  Everything must be equal: ids,
counts, thresholds and the similarity estimates."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import plan as jplan
from repro.core.lsh import minhash as jminhash, rbh as jrbh
from repro.core.types import Engine as JEngine, TopKMethod as JMethod
from repro.serve.retrieval import RetrievalService as JRetrievalService
from repro_torch.core import Engine, TopKMethod, plan_search
from repro_torch.core.lsh import minhash, rbh
from repro_torch.serve import RetrievalService

METHODS = ["cpq", "spq", "sort"]
M, DIM = 40, 12
# 5 adds, max_segments=3: a compaction after the fourth, then a segment below
# k (two batch shapes only: the reference traces its hashing once per shape)
BATCHES = [40, 7, 40, 40, 7]


def _same(got, want):
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold))


def _fill(svc, jsvc, emb):
    start = 0
    for rows in BATCHES:
        items = [f"doc{i}" for i in range(start, start + rows)]
        svc.add(items, embeddings=emb[start:start + rows])
        jsvc.add(items, embeddings=emb[start:start + rows])
        start += rows
    a, b = svc.index_stats, jsvc.index_stats
    assert a.segment_rows == b.segment_rows and a.compaction_count == b.compaction_count >= 1
    for field in ("n_objects", "bytes_device", "signature_layout", "bytes_signatures_wide",
                  "bytes_signatures_packed"):
        assert getattr(a, field) == getattr(b, field), field
    for seg, jseg in zip(svc._index.segments, jsvc._index.segments):
        assert np.array_equal(seg.data.numpy(), np.asarray(jseg.data))


def _searches_equal(svc, jsvc, queries):
    results = {}
    for method in METHODS:
        res, sims = svc.search(None, k=10, embeddings=queries, method=TopKMethod(method))
        jres, jsims = jsvc.search(None, k=10, embeddings=queries, method=JMethod(method))
        _same(res, jres)
        assert np.array_equal(sims, jsims)
        results[method] = res
    return results


def test_minhash_services_equal_reference_in_both_layouts(rng):
    """n_buckets = 128: the packed layout holds one byte per bucket id.  The
    reference draws its parameters at its first add; the port's service gets
    them through params_from_numpy, and its dim from its own first add."""
    emb = rng.standard_normal((sum(BATCHES), DIM)).astype(np.float32)
    emb[5] = -1.0                               # an empty support set
    queries = np.concatenate([emb[::17], emb[:3] + 0.01])
    cpq = {}
    for layout in ("wide", "packed"):
        jsvc = JRetrievalService(embed_fn=np.asarray, scheme="minhash", m_override=M,
                                 n_buckets=128, max_segments=3, signature_layout=layout)
        jsvc.add(["probe"], embeddings=emb[:1])
        jparams = jsvc._params
        # test code only: start the reference over with the same parameters
        jsvc = JRetrievalService(embed_fn=np.asarray, scheme="minhash", m_override=M,
                                 n_buckets=128, max_segments=3, signature_layout=layout)
        jsvc._params, jsvc._dim = jparams, DIM
        params = minhash.params_from_numpy(np.asarray(jparams.seeds),
                                           np.asarray(jparams.rehash_seeds), 128, device="cpu")
        svc = RetrievalService(scheme="minhash", m_override=M, n_buckets=128, max_segments=3,
                               device="cpu", signature_layout=layout, params=params)
        assert svc._dim is None                 # minhash fixes no input dimension
        _fill(svc, jsvc, emb)
        assert svc._dim == DIM and svc._index.engine is Engine.TANIMOTO
        cpq[layout] = _searches_equal(svc, jsvc, queries)["cpq"]
        assert svc.items_for(cpq[layout].ids[:1, :2]) == jsvc.items_for(
            np.asarray(cpq[layout].ids)[:1, :2])
    assert np.array_equal(cpq["packed"].ids.numpy(), cpq["wide"].ids.numpy())
    assert np.array_equal(cpq["packed"].counts.numpy(), cpq["wide"].counts.numpy())
    # self-retrieval of the unperturbed corpus points
    assert cpq["wide"].ids[:, 0].tolist()[:len(emb[::17])] == list(range(0, sum(BATCHES), 17))


def test_rbh_service_equals_reference(rng):
    """rbh -> EQ, WIDE only, with dyadic parameters carried over."""
    g = (2.0 ** rng.integers(0, 3, size=(M, DIM))).astype(np.float32)
    u = (rng.integers(0, 64, size=(M, DIM)) / 64.0 * g).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, size=(M, DIM)).astype(np.uint32)
    jsvc = JRetrievalService(embed_fn=np.asarray, scheme="rbh", m_override=M, max_segments=3)
    # test code only: install the parameters before the first add()
    jsvc._params = jrbh.RBHParams(g=jnp.asarray(g), u=jnp.asarray(u),
                                  dim_seeds=jnp.asarray(seeds), sigma=2.0, n_buckets=8192)
    jsvc._dim = DIM
    svc = RetrievalService(scheme="rbh", m_override=M, max_segments=3, device="cpu",
                           params=rbh.params_from_numpy(g, u, seeds, 2.0, 8192, device="cpu"))
    emb = rng.integers(-8, 9, size=(sum(BATCHES), DIM)).astype(np.float32)
    _fill(svc, jsvc, emb)
    assert svc._index.engine is Engine.EQ
    queries = np.concatenate([emb[::13], emb[:4] + 1.0])
    res = _searches_equal(svc, jsvc, queries)["cpq"]
    assert res.ids[:, 0].tolist()[:len(emb[::13])] == list(range(0, sum(BATCHES), 13))


def test_scheme_validation_equals_reference(rng):
    with pytest.raises(ValueError, match="no packed signature format"):
        RetrievalService(m_override=8, scheme="rbh", signature_layout="packed", device="cpu")
    # the service's default 8192 buckets do not fit a byte: the first add
    # refuses, with the reference's words
    emb = rng.standard_normal((30, 6)).astype(np.float32)
    jparams = jminhash.make(jax.random.PRNGKey(0), m=16, n_buckets=8192)
    params = minhash.params_from_numpy(np.asarray(jparams.seeds),
                                       np.asarray(jparams.rehash_seeds), 8192, device="cpu")
    with pytest.raises(ValueError) as ours:
        RetrievalService(m_override=16, scheme="minhash", signature_layout="packed",
                         device="cpu", params=params).add(range(30), embeddings=emb)
    jsvc = JRetrievalService(embed_fn=np.asarray, m_override=16, scheme="minhash",
                             signature_layout="packed")
    jsvc._params = jparams                      # test code only, before the first add()
    with pytest.raises(ValueError) as theirs:
        jsvc.add(range(30), embeddings=emb)
    assert str(ours.value) == str(theirs.value) and "[0, 253]" in str(ours.value)
    own = RetrievalService(scheme="minhash", m_override=8, n_buckets=200,
                           signature_layout="packed", device="cpu", seed=3)
    own.add(["a", "b"], embeddings=np.eye(2, 5, dtype=np.float32))
    assert own._params.dims == (8, None) and own._dim == 5
    with pytest.raises(ValueError, match="embedding dim 4 != dim 5"):
        own.add(["c"], embeddings=np.zeros((1, 4), np.float32))
    params = rbh.make(None, d=4, m=8, sigma=1.0, device="cpu")
    with pytest.raises(ValueError, match="m_override=8"):
        RetrievalService(scheme="rbh", m_override=9, device="cpu", params=params)


@pytest.mark.parametrize("layout,rows,n_objects", [
    ("monolithic", (300,), None), ("monolithic", (304,), 300),
    ("segmented", (40, 3, 200), None)])
@pytest.mark.parametrize("signature_layout", ["wide", "packed"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_describe_fused_match_equals_reference(layout, rows, n_objects, signature_layout,
                                               use_kernel):
    kw = dict(layout=layout, part_rows=rows, n_objects=n_objects, candidate_cap=33,
              use_kernel=use_kernel, signature_layout=signature_layout)
    plan = plan_search(Engine.TANIMOTO, 12, 40, method=TopKMethod.SORT, **kw)
    got = plan.describe()
    want = jplan.plan_search(JEngine.TANIMOTO, 12, 40, method=JMethod.SORT, **kw).describe()
    assert got == {key: want[key] for key in got}
    assert got["fused_match"] == (signature_layout == "packed" and use_kernel
                                  and n_objects is None)
    assert plan.pad_value == (255 if signature_layout == "packed" else -1)
