"""The simhash slice as a whole: GenieIndex.build_cosine, the planner's fused
gating and RetrievalService(scheme="simhash") of the port against the JAX
package's, in the WIDE and PACKED signature layouts, for CPQ / SPQ / SORT
(SegmentedIndex on its own: tests/test_torch_cosine_segments.py).

PACKED plans on the kernel path take the fused match -> count -> per-tile
top-k kernel (on the CPU its plain version); the reference is run on the same
path (use_kernel=True: its Pallas kernel in interpret mode) where the result
depends on it, which is the monolithic threshold.  Inputs are integer
vectors and dyadic simhash parameters, so every float32 projection is exact
and everything must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core import plan as jplan
from repro.core.lsh import simhash as jsimhash
from repro.core.types import Engine as JEngine, TopKMethod as JMethod
from repro.serve.retrieval import RetrievalService as JRetrievalService
from repro_torch.core import Engine, GenieIndex, TopKMethod, plan_search
from repro_torch.core.lsh import simhash
from repro_torch.serve import RetrievalService

METHODS = ["cpq", "spq", "sort"]


def _same(got, want, threshold=True):
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    if threshold:
        assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold))


def _vectors(rng, n, v=45):
    return rng.integers(-3, 4, size=(n, v)).astype(np.float32)


@pytest.mark.parametrize("layout", ["wide", "packed"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_genie_index_build_cosine_equals_reference(layout, use_kernel, rng):
    data, q = _vectors(rng, 300), _vectors(rng, 7)
    idx = GenieIndex.build_cosine(data, use_kernel=use_kernel, signature_layout=layout,
                                  device="cpu")
    # the monolithic threshold depends on the path (fused: the k-th count),
    # so the reference runs the same one; WIDE results do not depend on it
    jidx = JGenieIndex.build_cosine(data, signature_layout=layout,
                                    use_kernel=use_kernel and layout == "packed")
    assert idx.max_count == jidx.max_count == 45
    assert np.array_equal(idx.data.numpy(), np.asarray(jidx.data))
    assert np.array_equal(idx.match_counts(q).numpy(), np.asarray(jidx.match_counts(q)))
    for field in ("n_objects", "n_lists", "total_postings", "bytes_device", "signature_layout",
                  "bytes_signatures_wide", "bytes_signatures_packed"):
        assert getattr(idx.stats, field) == getattr(jidx.stats, field), field
    for method, k in (("cpq", 1), ("cpq", 12), ("spq", 12), ("sort", 12)):
        _same(idx.search(q, k=k, method=TopKMethod(method)),
              jidx.search(q, k=k, method=JMethod(method)))


@pytest.mark.parametrize("layout,rows,n_objects", [
    ("monolithic", (300,), None), ("monolithic", (304,), 300),
    ("segmented", (40, 3, 200), None), ("segmented", tuple(range(1, 41)), None)])
@pytest.mark.parametrize("signature_layout", ["wide", "packed"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_describe_fused_match_equals_reference(layout, rows, n_objects, signature_layout,
                                               use_kernel):
    kw = dict(layout=layout, part_rows=rows, n_objects=n_objects, candidate_cap=33,
              use_kernel=use_kernel, signature_layout=signature_layout)
    plan = plan_search(Engine.COSINE, 12, 45, method=TopKMethod.SPQ, **kw)
    got = plan.describe()
    want = jplan.plan_search(JEngine.COSINE, 12, 45, method=JMethod.SPQ, **kw).describe()
    assert got == {key: want[key] for key in got}
    assert got["fused_match"] == (signature_layout == "packed" and use_kernel
                                  and n_objects is None)
    assert (plan.fused_match is not None) == got["fused_match"]


# ---------------------------------------------------------------------------
# The served slice
# ---------------------------------------------------------------------------

M, DIM = 40, 12
BATCHES = [40, 7, 95, 3, 60]                    # 5 adds, max_segments=3: a compaction


def _pair(rng, layout):
    v = rng.integers(-128, 129, size=(M, DIM)).astype(np.float32) / 64.0
    jsvc = JRetrievalService(embed_fn=np.asarray, scheme="simhash", m_override=M,
                             max_segments=3, signature_layout=layout)
    # test code only: install the parameters before the first add()
    jsvc._params, jsvc._dim = jsimhash.SimHashParams(v=jnp.asarray(v)), DIM
    svc = RetrievalService(scheme="simhash", m_override=M, max_segments=3, device="cpu",
                           signature_layout=layout, params=simhash.params_from_numpy(v, device="cpu"))
    return svc, jsvc


def test_services_equal_reference_in_both_layouts(rng):
    emb = rng.integers(-6, 7, size=(sum(BATCHES), DIM)).astype(np.float32)
    queries = np.concatenate([emb[::17], emb[:3] + 1.0])
    results = {}
    for layout in ("wide", "packed"):
        svc, jsvc = _pair(np.random.default_rng(7), layout)
        start = 0
        for rows in BATCHES:
            items = [f"doc{i}" for i in range(start, start + rows)]
            svc.add(items, embeddings=emb[start:start + rows])
            jsvc.add(items, embeddings=emb[start:start + rows])
            start += rows
        a, b = svc.index_stats, jsvc.index_stats
        assert a.segment_rows == b.segment_rows and a.compaction_count == b.compaction_count
        assert a.compaction_count >= 1 and a.signature_layout == b.signature_layout == layout
        assert a.bytes_signatures_packed == b.bytes_signatures_packed > 0
        assert a.bytes_device == b.bytes_device
        for seg, jseg in zip(svc._index.segments, jsvc._index.segments):
            assert np.array_equal(seg.data.numpy(), np.asarray(jseg.data))
        res, sims = svc.search(None, k=10, embeddings=queries)
        jres, jsims = jsvc.search(None, k=10, embeddings=queries)
        _same(res, jres)
        assert np.array_equal(sims, jsims)
        results[layout] = res
        assert svc.items_for(res.ids[:1, :2]) == jsvc.items_for(np.asarray(jres.ids)[:1, :2])
    _same(results["packed"], results["wide"])


def test_service_validation_and_parameter_shapes(rng):
    with pytest.raises(ValueError, match="no packed signature format"):
        RetrievalService(m_override=8, scheme="e2lsh", signature_layout="packed", device="cpu")
    params = simhash.make(torch.Generator().manual_seed(0), d=4, m=8, device="cpu")
    svc = RetrievalService(scheme="simhash", m_override=8, device="cpu", params=params)
    with pytest.raises(ValueError, match="embedding dim 5 != dim 4"):
        svc.add(["a"], embeddings=np.zeros((1, 5), np.float32))
    with pytest.raises(ValueError, match="m_override=8"):
        RetrievalService(scheme="simhash", m_override=9, device="cpu", params=params)
    own = RetrievalService(scheme="simhash", m_override=8, device="cpu", seed=3)
    own.add(["a", "b"], embeddings=np.eye(2, 4, dtype=np.float32))
    assert own._params.dims == (8, 4) and own._index.engine is Engine.COSINE
