"""SegmentedIndex over the COSINE engine of the port against the JAX
package's, in the WIDE and PACKED signature layouts, for CPQ / SPQ / SORT:
uneven segments, a segment with fewer rows than k, compaction (packed
segments concatenate row-wise), the padded export and a plan over it, and
the state handed over from the reference's segments.  PACKED segments on the
kernel path take the fused match -> count -> per-tile top-k kernel (on the
CPU its plain version); once the reference runs its own fused Pallas kernel
(interpret mode) too.  Integer inputs: everything must be equal."""
import numpy as np
import pytest
import torch

from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import plan as jplan
from repro.core.types import Engine as JEngine, TopKMethod as JMethod
from repro_torch.core import Engine, SegmentedIndex, TopKMethod, execute, plan_search

METHODS = ["cpq", "spq", "sort"]
ROWS = [37, 101, 5]                             # uneven, one segment below k


def _same(got, want):
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold))


def _vectors(rng, n, v=45):
    return rng.integers(-3, 4, size=(n, v)).astype(np.float32)


@pytest.mark.parametrize("layout", ["wide", "packed"])
def test_segmented_index_equals_reference(layout, rng):
    data, q = _vectors(rng, sum(ROWS)), _vectors(rng, 6)
    segs = {uk: SegmentedIndex(Engine.COSINE, use_kernel=uk, signature_layout=layout,
                               device="cpu") for uk in (True, False)}
    jseg = JSegmentedIndex(JEngine.COSINE, use_kernel=False, signature_layout=layout)
    start = 0
    for r in ROWS:
        for seg in segs.values():
            seg.add(data[start:start + r])
        jseg.add(data[start:start + r])
        start += r
    for seg in segs.values():
        assert seg.segment_rows == jseg.segment_rows == ROWS
    wants = {m: jseg.search(q, k=10, method=JMethod(m)) for m in METHODS}
    for seg in segs.values():
        for m in METHODS:
            _same(seg.search(q, k=10, method=TopKMethod(m)), wants[m])
    # compaction concatenates (packed) segments and never remaps an id
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
    # the padded export: pad rows hold the layout's fill
    padded, n = segs[True].concat_data(pad_multiple=64)
    jpadded, jn = jseg.concat_data(pad_multiple=64)
    assert n == jn and np.array_equal(padded.numpy(), np.asarray(jpadded))


def test_packed_fused_path_equals_reference_kernel(rng):
    """The reference's own fused Pallas kernel (interpret mode) through a
    segmented search, a segment below k included."""
    rows = [40, 6]
    data, q = _vectors(rng, sum(rows), v=70), _vectors(rng, 5, v=70)
    seg = SegmentedIndex(Engine.COSINE, signature_layout="packed", device="cpu")
    jseg = JSegmentedIndex(JEngine.COSINE, signature_layout="packed")
    start = 0
    for r in rows:
        seg.add(data[start:start + r])
        jseg.add(data[start:start + r])
        start += r
    _same(seg.search(q, k=8), jseg.search(q, k=8))


def test_from_segments_rebuilds_packed_from_the_reference_state(rng):
    rows = [12, 50, 7]
    data, q = _vectors(rng, sum(rows)), _vectors(rng, 4)
    jseg = JSegmentedIndex(JEngine.COSINE, use_kernel=False)
    start = 0
    for r in rows:
        jseg.add(data[start:start + r])
        start += r
    for layout in ("wide", "packed"):
        seg = SegmentedIndex.from_segments([np.asarray(s.data) for s in jseg.segments],
                                           engine="cosine", max_count=jseg.max_count,
                                           device="cpu", signature_layout=layout)
        assert seg.segment_rows == rows and seg.signature_layout.value == layout
        _same(seg.search(q, k=8), jseg.search(q, k=8))
        if layout == "packed":
            assert seg.segments[0].data.dtype == torch.int32
            assert tuple(seg.segments[0].data.shape) == (12, 2)


def test_padded_packed_plan_masks_pad_rows(rng):
    """n_objects set: no fusion, the packed count + _mask_pad_counts run, and
    pad rows (zero words) never reach a result."""
    data, q = _vectors(rng, 41), _vectors(rng, 3)
    seg = SegmentedIndex(Engine.COSINE, signature_layout="packed", device="cpu")
    jseg = JSegmentedIndex(JEngine.COSINE, signature_layout="packed", use_kernel=False)
    for lo, hi in ((0, 30), (30, 41)):
        seg.add(data[lo:hi])
        jseg.add(data[lo:hi])
    padded, n = seg.concat_data(pad_multiple=16)
    jpadded, _ = jseg.concat_data(pad_multiple=16)
    qw = seg.model.prepare_queries_for(q, torch.device("cpu"), "packed")
    jqw = jseg.model.prepare_queries_for(q, "packed")
    for method in METHODS:
        plan = plan_search(Engine.COSINE, 10, 45, part_rows=(48,), n_objects=n,
                           method=TopKMethod(method), signature_layout="packed")
        jp = jplan.plan_search(JEngine.COSINE, 10, 45, part_rows=(48,), n_objects=n,
                               method=JMethod(method), signature_layout="packed",
                               use_kernel=False)
        got = execute(plan, padded, qw)
        _same(got, jplan.execute(jp, jpadded, jqw))
        assert int(got.ids.max()) < n
