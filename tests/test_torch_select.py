"""Selection and merging of the port against the JAX package on the same
count matrices: heavy ties, k > N, all-equal rows, -1 pad columns.  Integer
from end to end, so ids, counts and thresholds must be equal -- including the
(count desc, id asc) tie-break and the -1 empty slots."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpq as jcpq, merge as jmerge, select as jselect, spq as jspq
from repro.core.types import SearchParams as JParams, TopKMethod as JMethod
from repro_torch.core import cpq, merge, select, spq
from repro_torch.core.types import SearchParams, TopKMethod, TopKResult
from repro_torch.kernels import cpq_compact as kcompact, ops as kops


def _cases():
    rng = np.random.default_rng(7)
    heavy = rng.integers(0, 4, size=(5, 200)).astype(np.int32)
    tiny = rng.integers(0, 6, size=(3, 7)).astype(np.int32)
    equal = np.full((4, 90), 2, np.int32)
    padded = rng.integers(0, 9, size=(4, 150)).astype(np.int32)
    padded[:, -13:] = -1
    spread = rng.integers(0, 41, size=(6, 300)).astype(np.int32)
    zeros = np.zeros((2, 64), np.int32)
    return {
        # name: (counts, k, max_count, candidate_cap)
        "heavy-ties": (heavy, 10, 3, None),
        "k-above-n": (tiny, 10, 5, None),
        "all-equal": (equal, 8, 4, None),
        "pad-columns": (padded, 12, 8, None),
        "spread": (spread, 17, 40, None),
        "spread-cap": (spread, 17, 40, 19),
        "all-zero": (zeros, 5, 7, None),
        "k-one": (spread, 1, 40, None),
    }


CASES = _cases()


def _same(got: TopKResult, want) -> None:
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert got.threshold.dtype == torch.int32
    assert np.array_equal(got.ids.cpu().numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.cpu().numpy(), np.asarray(want.counts))
    assert np.array_equal(got.threshold.cpu().numpy(), np.asarray(want.threshold))


@pytest.mark.parametrize("name", sorted(CASES))
def test_histogram_and_gate(name):
    c, k, max_count, _ = CASES[name]
    hist = cpq.count_histogram(torch.from_numpy(c), max_count)
    jhist = jcpq.count_histogram(jnp.asarray(c), max_count)
    assert hist.dtype == torch.int32
    assert np.array_equal(hist.numpy(), np.asarray(jhist))
    assert np.array_equal(cpq.zipper_array(hist).numpy(), np.asarray(jcpq.zipper_array(jhist)))
    at, thr = cpq.audit_threshold(hist, k)
    jat, jthr = jcpq.audit_threshold(jhist, k)
    assert at.dtype == torch.int32 and thr.dtype == torch.int32
    assert np.array_equal(at.numpy(), np.asarray(jat))
    assert np.array_equal(thr.numpy(), np.asarray(jthr))


def test_gate_with_a_one_bin_domain():
    """max_count == 0: no t >= 1 exists, AT = 1, threshold 0."""
    hist = torch.tensor([[5], [0]], dtype=torch.int32)
    at, thr = cpq.audit_threshold(hist, 3)
    assert at.tolist() == [1, 1] and thr.tolist() == [0, 0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_compact_candidates(name):
    c, k, max_count, cap = CASES[name]
    cap = cap or max(2 * k, k + 16)
    for thr_val in (0, 1, max_count):
        thr = np.full((c.shape[0],), thr_val, np.int32)
        thr[::2] = max(thr_val - 1, 0)
        ids, vals = cpq._compact_candidates(torch.from_numpy(c), torch.from_numpy(thr), cap)
        jids, jvals = jcpq._compact_candidates(jnp.asarray(c), jnp.asarray(thr), cap)
        assert tuple(ids.shape) == (c.shape[0], cap)
        assert np.array_equal(ids.numpy(), np.asarray(jids))
        assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_topk_from_candidates_is_stable_on_ties(rng):
    vals = rng.integers(-1, 3, size=(6, 50)).astype(np.int32)
    ids = np.tile(np.arange(50, dtype=np.int32), (6, 1))
    ids[vals < 0] = -1
    for k in (1, 7, 50):
        gi, gv = cpq.topk_from_candidates(torch.from_numpy(ids), torch.from_numpy(vals), k)
        ji, jv = jcpq.topk_from_candidates(jnp.asarray(ids), jnp.asarray(vals), k)
        assert np.array_equal(gi.numpy(), np.asarray(ji))
        assert np.array_equal(gv.numpy(), np.asarray(jv))
    # id ascending inside every run of equal counts
    gi, gv = gi.numpy(), gv.numpy()
    for row_i, row_v in zip(gi, gv):
        for v in np.unique(row_v[row_v >= 0]):
            run = row_i[row_v == v]
            assert np.all(np.diff(run) > 0)


def _refuse(*args, **kwargs):
    raise AssertionError("the plain path called a kernel wrapper")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("method", ["cpq", "spq", "sort"])
def test_select_topk_equals_reference(name, method, device, monkeypatch):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    c, k, max_count, cap = CASES[name]
    counts = torch.from_numpy(c).to(device)
    if method == "sort" and k > c.shape[1]:
        with pytest.raises(ValueError):     # a full sort cannot return k > N
            select.select_topk(counts, SearchParams(
                k=k, max_count=max_count, method=TopKMethod.SORT))
        return
    params = SearchParams(k=k, max_count=max_count, method=TopKMethod(method), candidate_cap=cap)
    jparams = JParams(k=k, max_count=max_count, method=JMethod(method), candidate_cap=cap)
    want = jselect.select_topk(jnp.asarray(c), jparams)
    # the kernel path: the CUDA kernels, or their plain versions on a CPU tensor
    _same(select.select_topk(counts, params), want)
    # the plain path calls neither kernel wrapper
    monkeypatch.setattr(kops, "cpq_hist", _refuse)
    monkeypatch.setattr(kcompact, "cpq_compact", _refuse)
    plain = dataclasses.replace(params, use_kernel=False)
    _same(select.select_topk(counts, plain), want)
    if method == "cpq":
        _same(cpq.cpq_select(counts, plain), jcpq.cpq_select(jnp.asarray(c), jparams))
    elif method == "spq":
        _same(spq.spq_select(counts, plain), jspq.spq_select(jnp.asarray(c), jparams))
    else:
        _same(cpq.sort_select(counts, plain), jcpq.sort_select(jnp.asarray(c), jparams))


def test_select_topk_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown top-k method"):
        select.select_topk(torch.zeros((1, 4), dtype=torch.int32),
                           SearchParams(k=1, max_count=3, method="nope"))


def test_narrow_count_dtypes_select_the_same(rng):
    c = rng.integers(0, 30, size=(4, 120)).astype(np.int32)
    params = SearchParams(k=9, max_count=29)
    want = select.select_topk(torch.from_numpy(c), params)
    for dtype in (torch.int8, torch.int16):
        got = select.select_topk(torch.from_numpy(c).to(dtype), params)
        assert torch.equal(got.ids, want.ids) and torch.equal(got.counts, want.counts)


def _part_buffers(rng, s, q, kp, n_per):
    """Per-part top-k buffers as the executor produces them: ids globalised,
    id-ascending inside equal counts, -1/-1 in empty slots."""
    ids = np.full((s, q, kp), -1, np.int32)
    cnt = np.full((s, q, kp), -1, np.int32)
    for i in range(s):
        c = rng.integers(0, 4, size=(q, n_per)).astype(np.int32)
        order = np.argsort(-c, axis=-1, kind="stable")[:, :kp]
        w = order.shape[1]
        ids[i, :, :w] = order + i * n_per
        cnt[i, :, :w] = np.take_along_axis(c, order, axis=-1)
    return ids, cnt


@pytest.mark.parametrize("s,q,kp,n_per,k", [(4, 3, 6, 20, 6), (5, 2, 4, 3, 9), (1, 2, 5, 9, 5),
                                             (3, 4, 8, 30, 5)])
def test_merges_equal_reference(s, q, kp, n_per, k, rng):
    ids, cnt = _part_buffers(rng, s, q, kp, n_per)
    tids, tcnt = torch.from_numpy(ids), torch.from_numpy(cnt)
    _same(merge.merge_topk(tids, tcnt, k), jmerge.merge_topk(jnp.asarray(ids), jnp.asarray(cnt), k))
    _same(merge.tree_merge(tids, tcnt, k), jmerge.tree_merge(jnp.asarray(ids), jnp.asarray(cnt), k))
    # ragged: part i keeps only its first kp - i % 3 columns
    widths = [max(1, kp - i % 3) for i in range(s)]
    _same(merge.merge_ragged([tids[i, :, :w] for i, w in enumerate(widths)],
                             [tcnt[i, :, :w] for i, w in enumerate(widths)], k),
          jmerge.merge_ragged([jnp.asarray(ids[i, :, :w]) for i, w in enumerate(widths)],
                              [jnp.asarray(cnt[i, :, :w]) for i, w in enumerate(widths)], k))
    if s >= 2:
        gi, gc = merge.merge_two(tids[0], tcnt[0], tids[1], tcnt[1], kp)
        ji, jc = jmerge.merge_two(jnp.asarray(ids[0]), jnp.asarray(cnt[0]),
                                  jnp.asarray(ids[1]), jnp.asarray(cnt[1]), kp)
        assert np.array_equal(gi.numpy(), np.asarray(ji))
        assert np.array_equal(gc.numpy(), np.asarray(jc))


def test_search_params_cap():
    for k, cap in [(1, None), (10, None), (100, None), (10, 4), (10, 64)]:
        assert SearchParams(k=k, max_count=9, candidate_cap=cap).cap() == \
            JParams(k=k, max_count=9, candidate_cap=cap).cap()
