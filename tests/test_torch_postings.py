"""The port's CSR postings engine (`repro_torch.core.postings`, the CPU-Idx
baseline and the paper's sub-list load balancing) against the JAX package's
`repro.core.postings` and against the dense EQ match, bit for bit."""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import match as jmatch
from repro.core.postings import PostingsIndex as JPostingsIndex
from repro_torch.core import match, postings
from repro_torch.core.postings import PostingsIndex
from repro_torch.kernels import ops


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq_keywords(rng, n, m, buckets):
    sigs = rng.integers(0, buckets, size=(n, m)).astype(np.int32)
    return sigs, sigs + (np.arange(m, dtype=np.int32) * buckets)[None, :]


def _zipf_keywords(rng, n, m, space):
    probs = 1.0 / np.arange(1, space + 1) ** 1.2
    return rng.choice(space, size=(n, m), p=probs / probs.sum()).astype(np.int32)


def _same_index(got, want):
    assert got.n_objects == want.n_objects and got.n_keywords == want.n_keywords
    assert np.array_equal(got.indptr, want.indptr) and got.indptr.dtype == want.indptr.dtype
    assert np.array_equal(got.indices, want.indices) and got.indices.dtype == want.indices.dtype
    g, w = dataclasses.asdict(got.stats), dataclasses.asdict(want.stats)
    assert g.pop("build_seconds") >= 0.0 and w.pop("build_seconds") >= 0.0
    assert g == w


CORPORA = {
    "eq-300x12": lambda rng: _eq_keywords(rng, 300, 12, 32)[1],
    "zipf-2000x8": lambda rng: _zipf_keywords(rng, 2000, 8, 64),
    "one-list": lambda rng: np.full((50, 1), 3, np.int32),
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_build_split_and_scans_equal_reference(corpus):
    rng = np.random.default_rng(11)
    keywords = CORPORA[corpus](rng)
    n_kw = int(keywords.max()) + 3                       # trailing empty lists
    got, want = PostingsIndex.build(keywords, n_kw), JPostingsIndex.build(keywords, n_kw)
    _same_index(got, want)
    q = keywords[:6]
    counts = got.scan_counts_numpy(q)
    assert counts.dtype == np.int32
    assert np.array_equal(counts, want.scan_counts_numpy(q))
    for limit in (1, 64, max(got.stats.max_list_len, 1)):
        tiles, tile_kw = got.split_tiles(limit)
        w_tiles, w_kw = want.split_tiles(limit)
        assert tiles.dtype == w_tiles.dtype and np.array_equal(tiles, w_tiles)
        assert tile_kw.dtype == w_kw.dtype and np.array_equal(tile_kw, w_kw)
        tiled = got.scan_counts_tiled(_t(tiles), _t(tile_kw), _t(q))
        w_tiled = np.asarray(want.scan_counts_tiled(
            jnp.asarray(w_tiles), jnp.asarray(w_kw), jnp.asarray(q)))
        assert tiled.dtype == torch.int32 and tiled.device.type == "cpu"
        assert np.array_equal(tiled.numpy(), w_tiled)


def test_reference_system_case_equals_dense_match(rng):
    """`tests/test_system.py::test_postings_engine_matches_dense` on the port:
    CPU-Idx, the tiled scan and the EQ match (plain and the kernel wrapper on
    CPU tensors) agree on positional keywords."""
    n, m, buckets = 300, 12, 32
    sigs, keywords = _eq_keywords(rng, n, m, buckets)
    pidx = PostingsIndex.build(keywords, n_keywords=m * buckets)
    q = keywords[:5]
    counts_np = pidx.scan_counts_numpy(q)
    dense = match.match_eq(_t(sigs), _t(sigs[:5]))
    assert np.array_equal(counts_np, dense.numpy())
    assert np.array_equal(counts_np, ops.match_count(_t(sigs), _t(sigs[:5])).numpy())
    assert np.array_equal(counts_np, np.asarray(jmatch.match_eq(
        jnp.asarray(sigs), jnp.asarray(sigs[:5]))))
    tiles, tile_kw = pidx.split_tiles(limit=64)
    assert np.array_equal(pidx.scan_counts_tiled(_t(tiles), _t(tile_kw), _t(q)).numpy(),
                          counts_np)


@pytest.mark.parametrize("budget", [1, 5000, 1 << 30])
def test_query_chunks_do_not_change_counts(budget):
    """The transient budget only decides how many queries share a chunk: one
    query a chunk, a few, or all of them give the same counts."""
    rng = np.random.default_rng(3)
    keywords = _zipf_keywords(rng, 1500, 8, 64)
    pidx = PostingsIndex.build(keywords, 64)
    tiles, tile_kw = pidx.split_tiles(128)
    q = np.concatenate([keywords[:9], np.full((1, 8), 70, np.int32),      # names no list
                        np.full((1, 8), -1, np.int32)])
    want = np.asarray(JPostingsIndex.build(keywords, 64).scan_counts_tiled(
        jnp.asarray(tiles), jnp.asarray(tile_kw), jnp.asarray(q)))
    got = pidx.scan_counts_tiled(_t(tiles), _t(tile_kw), _t(q), max_transient_bytes=budget)
    assert np.array_equal(got.numpy(), want)
    assert not got[-2:].any()


def test_repeated_query_keyword_counts_once_tiled_and_twice_on_cpu_idx():
    """A reference quirk kept: the tiled scan activates a list once however
    often a query names it (`any`), CPU-Idx scans it once per naming.  They
    agree on the query's distinct keywords."""
    keywords = np.array([[0, 1], [1, 2], [2, 2]], np.int32)
    q = np.array([[1, 1], [2, 0]], np.int32)
    pidx, jidx = PostingsIndex.build(keywords, 3), JPostingsIndex.build(keywords, 3)
    tiles, tile_kw = pidx.split_tiles(2)
    tiled = pidx.scan_counts_tiled(_t(tiles), _t(tile_kw), _t(q)).numpy()
    assert np.array_equal(tiled, np.asarray(jidx.scan_counts_tiled(
        jnp.asarray(tiles), jnp.asarray(tile_kw), jnp.asarray(q))))
    assert tiled.tolist() == [[1, 1, 0], [1, 1, 2]]
    assert pidx.scan_counts_numpy(q).tolist() == [[2, 2, 0], [1, 1, 2]]
    for row in range(2):
        distinct = np.unique(q[row])[None]
        assert np.array_equal(pidx.scan_counts_numpy(distinct)[0], tiled[row])


def test_empty_and_single_list_indexes():
    empty = np.zeros((0, 4), np.int32)
    got, want = PostingsIndex.build(empty, 5), JPostingsIndex.build(empty, 5)
    _same_index(got, want)
    tiles, tile_kw = got.split_tiles(8)
    assert tiles.shape == (0, 8) and tile_kw.shape == (0,)
    assert got.scan_counts_tiled(_t(tiles), _t(tile_kw), _t(np.zeros((2, 4), np.int32))
                                 ).shape == (2, 0)
    assert got.scan_counts_numpy(np.zeros((2, 4), np.int32)).shape == (2, 0)
    single = np.zeros((7, 1), np.int32)
    got = PostingsIndex.build(single, 1)
    _same_index(got, JPostingsIndex.build(single, 1))
    assert got.stats.n_lists == 1 and got.stats.max_list_len == 7
    tiles, tile_kw = got.split_tiles(3)
    assert tiles.shape == (3, 3) and tile_kw.tolist() == [0, 0, 0]
    counts = got.scan_counts_tiled(_t(tiles), _t(tile_kw), _t(np.zeros((2, 1), np.int32)))
    assert counts.tolist() == [[1] * 7] * 2
    assert got.scan_counts_tiled(_t(tiles), _t(tile_kw),
                                 _t(np.zeros((0, 1), np.int32))).shape == (0, 7)


def test_tensors_on_two_devices_are_refused():
    pidx = PostingsIndex.build(np.zeros((2, 1), np.int32), 1)
    tiles, tile_kw = pidx.split_tiles(2)
    with pytest.raises(ValueError, match="share a device"):
        pidx.scan_counts_tiled(_t(tiles), _t(tile_kw).to("meta"), _t(np.zeros((1, 1), np.int32)))


def test_build_clock_is_monotonic():
    """As `tests/test_routing.py` holds the reference: build durations come
    from the monotonic clock, never the wall clock."""
    src = inspect.getsource(postings)
    assert "time.time()" not in src and "perf_counter" in src
