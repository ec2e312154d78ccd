"""The TANIMOTO kernel layer, GenieIndex.build_tanimoto and SegmentedIndex over
TANIMOTO against the JAX package's.  The same numpy inputs go through
`repro.kernels.ops` (the Pallas kernels in interpret mode at small tiles, as
tests/test_kernels.py and tests/test_packed.py run them) and through
`repro_torch.kernels.ops` on the CPU, where the wrappers take their plain
PyTorch versions (the CUDA kernels themselves are held against the same plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py).  Bucket
ids include 0 and 253, the ends of the packed domain.  Everything is integer:
equality, no tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import cpq as jcpq, match as jmatch, packing as jpacking
from repro.core import plan as jplan
from repro.core.types import Engine as JEngine, SearchParams as JSearchParams
from repro.core.types import TopKMethod as JMethod
from repro.kernels import ops as jops
from repro_torch.core import (Engine, GenieIndex, SegmentedIndex, TopKMethod, execute,
                              packing, plan_search)
from repro_torch.core.plan import _fused_candidates_topk
from repro_torch.kernels import ops
from repro_torch.kernels.packed_tanimoto import (TILE_N, packed_tanimoto_count,
                                                 packed_tanimoto_count_plain,
                                                 packed_tanimoto_topk_plain)
from repro_torch.kernels.tanimoto_count import tanimoto_count, tanimoto_count_plain

METHODS = ["cpq", "spq", "sort"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _buckets(rng, n, m, hi=254):
    b = rng.integers(0, hi, size=(n, m)).astype(np.int32)
    b.flat[0], b.flat[-1] = 0, hi - 1            # the ends of the domain
    return b


def _same(got, want, threshold=True):
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    if threshold:
        assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold))


# ---------------------------------------------------------------------------
# The three kernel wrappers (plain on the CPU) against the reference kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,m", [(1, 5, 3), (3, 130, 17), (2, 90, 600)])
def test_tanimoto_count_equals_reference_kernel(q, n, m, rng):
    d = rng.integers(0, 64, size=(n, m)).astype(np.int32)
    s = rng.integers(0, 64, size=(q, m)).astype(np.int32)
    got = ops.tanimoto_count(_t(d).to(torch.int16), _t(s))      # the entry casts to int32
    kernel = np.asarray(jops.tanimoto_count(jnp.asarray(d), jnp.asarray(s),
                                            tile_q=8, tile_n=128, tile_m=128))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert torch.equal(tanimoto_count(_t(d), _t(s)), tanimoto_count_plain(_t(d), _t(s)))


@pytest.mark.parametrize("n,q,m", [(7, 3, 5), (130, 5, 17), (64, 4, 40), (40, 2, 600)])
def test_packed_tanimoto_count_equals_reference_kernel(n, q, m):
    rng = np.random.default_rng(n * m)
    d, s = _buckets(rng, n, m), _buckets(rng, q, m)
    s[0] = d[1]                                  # a full collision
    pd, ps = packing.pack_buckets(_t(d)), packing.pack_buckets(_t(s))
    got = ops.packed_tanimoto_count(pd, ps)
    want = np.asarray(jops.packed_tanimoto_count(jpacking.pack_buckets(jnp.asarray(d)),
                                                 jpacking.pack_buckets(jnp.asarray(s))))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.asarray(jmatch.match_tanimoto(jnp.asarray(d), jnp.asarray(s))))
    assert int(got[0, 1]) == m
    assert torch.equal(packed_tanimoto_count(pd, ps), packed_tanimoto_count_plain(pd, ps))


def _reference_tile(n: int) -> int:
    """The tile the TPU wrapper picks (kernels/common.pick_tile, 256 / 128)."""
    return 256 if n >= 256 else -(-n // 128) * 128


@pytest.mark.parametrize("n,q,m,k", [(7, 3, 5, 3), (130, 5, 17, 10), (300, 4, 238, 7)])
def test_packed_tanimoto_topk_equals_reference_kernel(n, q, m, k):
    """At the reference's tile the plain buffers equal the Pallas kernel's
    slot for slot; at the port's own tile the merged result equals the
    reference's and a sort of the counts."""
    rng = np.random.default_rng(n + m)
    d, s = _buckets(rng, n, m, hi=6), _buckets(rng, q, m, hi=6)   # many ties
    pd, ps = packing.pack_buckets(_t(d)), packing.pack_buckets(_t(s))
    jids, jcnts = jops.packed_tanimoto_topk(jpacking.pack_buckets(jnp.asarray(d)),
                                            jpacking.pack_buckets(jnp.asarray(s)), k=k)
    pids, pcnts = packed_tanimoto_topk_plain(pd, ps, k, tile_n=_reference_tile(n))
    assert np.array_equal(pids.numpy(), np.asarray(jids))
    assert np.array_equal(pcnts.numpy(), np.asarray(jcnts))

    ids, cnts = ops.packed_tanimoto_topk(pd, ps, k=k)          # the port's tile
    assert tuple(ids.shape) == (q, -(-n // TILE_N) * min(k, TILE_N))
    got = _fused_candidates_topk(lambda *_: (ids, cnts), None, None, k)
    want = jcpq.topk_from_candidates(jids, jcnts, k)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    counts = jmatch.match_tanimoto(jnp.asarray(d), jnp.asarray(s))
    oracle = jcpq.sort_select(counts, JSearchParams(k=k, max_count=m))
    assert np.array_equal(got[0].numpy(), np.asarray(oracle.ids))
    assert np.array_equal(got[1].numpy(), np.asarray(oracle.counts))


@pytest.mark.parametrize("n,k,tile_n", [(5000, 3, 2048), (50, 100, 2048), (700, 9, 64)])
def test_plain_topk_buffers_follow_the_contract(n, k, tile_n, rng):
    """Tiles ascending, (count desc, id asc) inside a tile, no id past N,
    exhausted slots -1 / -1, kc = min(k, tile_n) slots per tile."""
    pd = packing.pack_buckets(_t(_buckets(rng, n, 9, hi=4)))
    ps = packing.pack_buckets(_t(_buckets(rng, 3, 9, hi=4)))
    ids, cnts = packed_tanimoto_topk_plain(pd, ps, k, tile_n=tile_n)
    counts = packed_tanimoto_count_plain(pd, ps).numpy()
    kc, n_tiles = min(k, tile_n), -(-n // tile_n)
    assert tuple(ids.shape) == (3, n_tiles * kc)
    for row in range(3):
        for t in range(n_tiles):
            sl = slice(t * kc, (t + 1) * kc)
            i, c = ids[row, sl].numpy(), cnts[row, sl].numpy()
            lo, hi = t * tile_n, min((t + 1) * tile_n, n)
            real = i >= 0
            assert np.all((c == -1) == ~real) and np.all(real[:real.sum()])
            assert np.all((i[real] >= lo) & (i[real] < hi))
            order = sorted(zip(-counts[row, lo:hi], range(lo, hi)))[:kc]
            assert [j for _, j in order] == i[real].tolist()
            assert np.array_equal(c[real], counts[row, i[real]])


def test_fused_tie_break_is_count_desc_id_asc():
    """All-equal rows: the buffers surface the lowest ids."""
    d = torch.full((40, 8), 253, dtype=torch.uint8)
    s = torch.full((2, 8), 253, dtype=torch.uint8)
    ids, cnts = ops.packed_tanimoto_topk(d, s, k=5)
    got_ids, got_cnts = _fused_candidates_topk(lambda *_: (ids, cnts), None, None, 5)
    assert got_ids.tolist() == [list(range(5))] * 2
    assert bool((got_cnts == 8).all())


# ---------------------------------------------------------------------------
# GenieIndex.build_tanimoto
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["wide", "packed"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_genie_index_build_tanimoto_equals_reference(layout, use_kernel, rng):
    data, q = _buckets(rng, 300, 20, hi=12), _buckets(rng, 7, 20, hi=12)
    idx = GenieIndex.build_tanimoto(data, use_kernel=use_kernel, signature_layout=layout,
                                    device="cpu")
    # the monolithic threshold depends on the path (fused: the k-th count),
    # so the reference runs the same one; WIDE results do not depend on it
    jidx = JGenieIndex.build_tanimoto(data, signature_layout=layout,
                                      use_kernel=use_kernel and layout == "packed")
    assert idx.engine is Engine.TANIMOTO and idx.max_count == jidx.max_count == 20
    assert idx.data.dtype == (torch.uint8 if layout == "packed" else torch.int32)
    assert np.array_equal(idx.data.numpy(), np.asarray(jidx.data))
    assert np.array_equal(idx.match_counts(q).numpy(), np.asarray(jidx.match_counts(q)))
    for field in ("n_objects", "n_lists", "total_postings", "bytes_device", "signature_layout",
                  "bytes_signatures_wide", "bytes_signatures_packed"):
        assert getattr(idx.stats, field) == getattr(jidx.stats, field), field
    for method, k in (("cpq", 1), ("cpq", 12), ("spq", 12), ("sort", 12)):
        _same(idx.search(q, k=k, method=TopKMethod(method)),
              jidx.search(q, k=k, method=JMethod(method)))


def test_packed_tanimoto_rejects_what_does_not_fit_a_byte(rng):
    with pytest.raises(ValueError) as ours:
        GenieIndex.build_tanimoto(_buckets(rng, 5, 4, hi=300), signature_layout="packed",
                                  device="cpu")
    with pytest.raises(ValueError) as theirs:
        JGenieIndex.build_tanimoto(_buckets(rng, 5, 4, hi=300), signature_layout="packed")
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# SegmentedIndex over TANIMOTO
# ---------------------------------------------------------------------------

ROWS = [37, 101, 5]                             # uneven, one segment below k


@pytest.mark.parametrize("layout", ["wide", "packed"])
def test_segmented_index_equals_reference_through_a_compaction(layout, rng):
    data, q = _buckets(rng, sum(ROWS), 24, hi=10), _buckets(rng, 6, 24, hi=10)
    segs = {uk: SegmentedIndex(Engine.TANIMOTO, use_kernel=uk, signature_layout=layout,
                               device="cpu") for uk in (True, False)}
    jseg = JSegmentedIndex(JEngine.TANIMOTO, use_kernel=False, signature_layout=layout)
    start = 0
    for r in ROWS:
        for seg in segs.values():
            seg.add(data[start:start + r])
        jseg.add(data[start:start + r])
        start += r
    wants = {m: jseg.search(q, k=10, method=JMethod(m)) for m in METHODS}
    for seg in segs.values():
        assert seg.segment_rows == jseg.segment_rows == ROWS
        for m in METHODS:
            _same(seg.search(q, k=10, method=TopKMethod(m)), wants[m])
    jseg.compact(max_segments=2)
    for seg in segs.values():
        seg.compact(max_segments=2)
        assert seg.segment_rows == jseg.segment_rows
        for m in METHODS:
            _same(seg.search(q, k=10, method=TopKMethod(m)), wants[m])
        a, b = seg.stats, jseg.stats
        for field in ("n_objects", "total_postings", "bytes_device", "signature_layout",
                      "bytes_signatures_wide", "bytes_signatures_packed", "compaction_count"):
            assert getattr(a, field) == getattr(b, field), field
    # the padded export: pad rows hold the layout's fill (-1, or 255 packed)
    padded, n = segs[True].concat_data(pad_multiple=64)
    jpadded, jn = jseg.concat_data(pad_multiple=64)
    assert n == jn and np.array_equal(padded.numpy(), np.asarray(jpadded))
    assert int(padded[-1, 0]) == (255 if layout == "packed" else -1)


def test_padded_packed_plan_masks_pad_rows_and_runs_the_count(rng):
    """n_objects set: no fusion, packed_tanimoto_count + _mask_pad_counts run,
    and pad rows (255 bytes) never reach a result."""
    data, q = _buckets(rng, 41, 16, hi=8), _buckets(rng, 3, 16, hi=8)
    seg = SegmentedIndex(Engine.TANIMOTO, signature_layout="packed", device="cpu")
    jseg = JSegmentedIndex(JEngine.TANIMOTO, signature_layout="packed", use_kernel=False)
    for lo, hi in ((0, 30), (30, 41)):
        seg.add(data[lo:hi])
        jseg.add(data[lo:hi])
    padded, n = seg.concat_data(pad_multiple=16)
    jpadded, _ = jseg.concat_data(pad_multiple=16)
    qp = seg.model.prepare_queries_for(q, torch.device("cpu"), "packed")
    jqp = jseg.model.prepare_queries_for(q, "packed")
    assert qp.dtype == torch.uint8
    for method in METHODS:
        plan = plan_search(Engine.TANIMOTO, 10, 16, part_rows=(48,), n_objects=n,
                           method=TopKMethod(method), signature_layout="packed")
        assert plan.fused_match is None
        jp = jplan.plan_search(JEngine.TANIMOTO, 10, 16, part_rows=(48,), n_objects=n,
                               method=JMethod(method), signature_layout="packed",
                               use_kernel=False)
        got = execute(plan, padded, qp)
        _same(got, jplan.execute(jp, jpadded, jqp))
        assert int(got.ids.max()) < n


def test_from_segments_rebuilds_packed_from_the_reference_state(rng):
    rows = [12, 50, 7]
    data, q = _buckets(rng, sum(rows), 20, hi=9), _buckets(rng, 4, 20, hi=9)
    jseg = JSegmentedIndex(JEngine.TANIMOTO, use_kernel=False)
    start = 0
    for r in rows:
        jseg.add(data[start:start + r])
        start += r
    for layout in ("wide", "packed"):
        seg = SegmentedIndex.from_segments([np.asarray(s.data) for s in jseg.segments],
                                           engine="tanimoto", max_count=jseg.max_count,
                                           device="cpu", signature_layout=layout)
        assert seg.segment_rows == rows and seg.signature_layout.value == layout
        _same(seg.search(q, k=8), jseg.search(q, k=8))
