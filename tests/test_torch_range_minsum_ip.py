"""The RANGE, MINSUM and IP engines of the port against the JAX package's.

The same numpy inputs go through `repro.kernels.ops` (the Pallas kernels in
interpret mode at small tiles, as tests/test_kernels.py runs them),
`repro.core.match` and `repro.core.{GenieIndex, SegmentedIndex}`, and through
their counterparts in `repro_torch` on the CPU, where the kernel wrappers take
their plain PyTorch versions (the CUDA kernels themselves are held against the
same plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py).
Everything is integer: `ids`, `counts` and `threshold` equal, no tolerance."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core import SegmentedIndex as JSegmentedIndex
from repro.core import cpq as jcpq, engines as jengines, match as jmatch
from repro.core import plan as jplan
from repro.core.sa import document as jdocument, relational as jrelational
from repro.core.types import Engine as JEngine, SearchParams as JSearchParams
from repro.core.types import TopKMethod as JMethod
from repro.data.pipeline import mutate_sequence, synthetic_sequences
from repro.kernels import ops as jops
from repro_torch.core import (Engine, GenieIndex, SegmentedIndex, TopKMethod, engines,
                              execute, plan_search)
from repro_torch.core.match import match_minsum
from repro_torch.core.sa import document, ngram, relational, verify
from repro_torch.kernels import build, common, ops, ref
from repro_torch.kernels.ip_count import ip_count, ip_count_plain
from repro_torch.kernels.minsum_count import minsum_count, minsum_count_plain
from repro_torch.kernels.range_count import range_count, range_count_plain

METHODS = ["cpq", "spq", "sort"]
NEW = [Engine.RANGE, Engine.MINSUM, Engine.IP]
I32 = np.iinfo(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(got, want, threshold=True):
    assert got.ids.dtype == torch.int32 and got.counts.dtype == torch.int32
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    if threshold:
        assert np.array_equal(got.threshold.numpy(), np.asarray(want.threshold))


def _ranges(rng, q, d, hi=64):
    lo = rng.integers(0, hi, size=(q, d)).astype(np.int32)
    width = rng.integers(-3, 20, size=(q, d)).astype(np.int32)   # some empty ranges
    return lo, lo + width


# ---------------------------------------------------------------------------
# The three kernel wrappers (plain on the CPU) against the reference kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n,d", [(1, 5, 1), (3, 130, 3), (4, 300, 14), (2, 129, 37)])
def test_range_count_equals_reference_kernel(q, n, d, rng):
    x = rng.integers(0, 64, size=(n, d)).astype(np.int32)
    lo, hi = _ranges(rng, q, d)
    hi[0, 0] = lo[0, 0]                                  # lo == hi
    got = ops.range_count(_t(x).to(torch.int16), _t(lo), _t(hi))   # the entry casts
    kernel = np.asarray(jops.range_count(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi),
                                         tile_q=8, tile_n=128))
    oracle = np.asarray(jmatch.match_range(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert np.array_equal(kernel, oracle)
    assert torch.equal(range_count(_t(x), _t(lo), _t(hi)), range_count_plain(_t(x), _t(lo), _t(hi)))
    assert np.array_equal(ref.match_range(_t(x), _t(lo), _t(hi)).numpy(), oracle)


def test_range_count_at_the_ends_of_int32(rng):
    """INT32_MIN (the engine's pad fill) and INT32_MAX values, full and empty
    ranges, lo == hi at both ends."""
    x = rng.integers(-5, 5, size=(40, 9)).astype(np.int32)
    x[::3, 0], x[1::3, 1] = I32.min, I32.max
    lo, hi = _ranges(rng, 5, 9, hi=5)
    lo[0], hi[0] = I32.min, I32.max                      # everything
    lo[1], hi[1] = I32.max, I32.min                      # nothing
    lo[2], hi[2] = I32.min, I32.min
    lo[3], hi[3] = I32.max, I32.max
    got = ops.range_count(_t(x), _t(lo), _t(hi)).numpy()
    assert np.array_equal(got, np.asarray(jmatch.match_range(jnp.asarray(x), jnp.asarray(lo),
                                                             jnp.asarray(hi))))
    assert np.array_equal(got, jrelational.exact_range_count(x, lo, hi))
    assert (got[0] == 9).all() and (got[1] == 0).all()


@pytest.mark.parametrize("q,n,v", [(1, 5, 1), (2, 90, 33), (3, 260, 200), (1, 40, 513)])
@pytest.mark.parametrize("dtype", [np.int32, np.int8])
def test_minsum_count_equals_reference_kernel(q, n, v, dtype, rng):
    dc = rng.integers(0, 128, size=(n, v)).astype(dtype)           # up to the clip
    qc = rng.integers(0, 128, size=(q, v)).astype(dtype)
    dc[0] = -1                                                      # the engine's pad row
    got = ops.minsum_count(_t(dc), _t(qc))
    kernel = np.asarray(jops.minsum_count(jnp.asarray(dc), jnp.asarray(qc),
                                          tile_q=8, tile_n=128, tile_v=128))
    oracle = np.asarray(jmatch.match_minsum(jnp.asarray(dc.astype(np.int32)),
                                            jnp.asarray(qc.astype(np.int32))))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert np.array_equal(kernel, oracle)
    assert int(got[0, 0]) == -v                          # a pad row sums below -1
    d32, q32 = _t(dc.astype(np.int32)), _t(qc.astype(np.int32))
    assert torch.equal(minsum_count(d32, q32), minsum_count_plain(d32, q32))


def _sparse_counts(rng, rows, v, kind):
    """MINSUM operands in the sparse regime: at most 38 non-zero buckets a
    row (a 40-letter title's 3-grams) and every 7th row all zero; "wrap" puts
    values within 8 of INT32_MAX on them and INT32_MIN in every 5th column, so
    that the sums wrap."""
    x = np.zeros((rows, v), dtype=np.int32)
    nz = min(38, v)
    lo, hi = (1, 128) if kind == "sparse" else (I32.max - 8, I32.max)
    for r in range(rows):
        x[r, rng.choice(v, size=nz, replace=False)] = rng.integers(lo, hi, size=nz)
    x[::7] = 0
    if kind == "wrap":
        x[:, ::5] = I32.min
    return x


@pytest.mark.parametrize("kind,q,n,v", [("sparse", 3, 130, 4096), ("sparse", 2, 60, 4097),
                                        ("wrap", 2, 60, 4096), ("wrap", 3, 40, 300)])
def test_minsum_count_sparse_regime_equals_reference_kernel(kind, q, n, v, rng):
    """The sparse regime the CUDA kernel is built for, against the interpret-
    mode Pallas kernel: <= 38 non-zeros a row of 4096, all-zero rows, -1 pad
    rows, and values near INT32_MAX whose sums wrap."""
    dc, qc = _sparse_counts(rng, n, v, kind), _sparse_counts(rng, q, v, kind)
    dc[1::9] = -1                                                   # the engine's pad rows
    got = ops.minsum_count(_t(dc), _t(qc))
    kernel = np.asarray(jops.minsum_count(jnp.asarray(dc), jnp.asarray(qc),
                                          tile_q=8, tile_n=128, tile_v=512))
    oracle = np.asarray(jmatch.match_minsum(jnp.asarray(dc), jnp.asarray(qc)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert np.array_equal(kernel, oracle)
    if kind == "sparse":
        assert (dc == 0).all(axis=1).any()                           # all-zero rows


@pytest.mark.parametrize("kind", ["sparse", "wrap", "dense"])
def test_sparse_minsum_identity_equals_reference(kind, rng):
    """The conversion to lists (csrc/minsum_count.cu's minsum_nnz and
    minsum_csr, here their plain versions) keeps every non-zero entry of a
    row in column order: a walk over each row's list, done in uint32,
    equals the reference bit for bit, wraparound included:
    sum_v min(d, q) = sum_v min(0, q) + sum_{d != 0} [min(d, q) - min(0, q)]."""
    from repro_torch.kernels.minsum_count import (minsum_csr_plain, minsum_nnz_plain,
                                                  minsum_nnz, minsum_csr)
    q, n, v = 3, 50, 700
    if kind == "dense":
        dc = rng.integers(-3, 128, size=(n, v)).astype(np.int32)
        qc = rng.integers(-3, 128, size=(q, v)).astype(np.int32)
    else:
        dc, qc = _sparse_counts(rng, n, v, kind), _sparse_counts(rng, q, v, kind)
    dc[::9] = -1
    d = _t(dc)
    entries, nnz = minsum_csr_plain(d), minsum_nnz_plain(d)
    assert torch.equal(minsum_nnz(d), nnz) and torch.equal(minsum_csr(d, None, 0), entries)
    assert int(nnz.sum()) == entries.shape[0] == int((dc != 0).sum())
    mask = 0xFFFFFFFF
    q64 = qc.astype(np.int64)
    base = np.minimum(0, q64).sum(axis=1) & mask                     # [Q]
    got = np.zeros((q, n), dtype=np.int64)
    at = 0
    for r, cnt in enumerate(nnz.tolist()):
        cols = entries[at:at + cnt, 0].numpy()
        vals = entries[at:at + cnt, 1].numpy().astype(np.int64)
        assert (np.diff(cols) > 0).all()                              # columns ascending
        qv = q64[:, cols]
        got[:, r] = (base + (np.minimum(vals[None, :], qv) - np.minimum(0, qv)).sum(axis=1)) & mask
        at += cnt
    want = np.asarray(jmatch.match_minsum(jnp.asarray(dc), jnp.asarray(qc)))
    assert np.array_equal(got.astype(np.uint32).view(np.int32), want)


def _minsum_values(g: torch.Generator, shape, kind: str) -> torch.Tensor:
    """int32 count vectors a third non-zero: "counts" 1..127; "negative" -3..127
    with -1 rows (the engine's pad); "wrap" values within 8 of either end of
    int32, so that sums overflow."""
    if kind == "counts":
        x = torch.randint(1, 128, shape, generator=g, dtype=torch.int32)
    elif kind == "negative":
        x = torch.randint(-3, 128, shape, generator=g, dtype=torch.int32)
        x[::4] = -1
    else:
        near = torch.randint(0, 8, shape, generator=g, dtype=torch.int64)
        top = torch.rand(shape, generator=g) < 0.5
        x = torch.where(top, I32.max - near, I32.min + near).to(torch.int32)
    keep = torch.rand(shape, generator=g) < 1 / 3
    if kind == "negative":
        keep[::4] = True
    return x * keep


@pytest.mark.parametrize("kind", ["counts", "negative", "wrap"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_inverted_walk_identity_equals_match_minsum(kind, seed):
    """The identity the inverted walk sums (csrc/minsum_count.cu), in plain
    PyTorch over the dense vectors, equals `match_minsum` bit for bit in
    uint32, wraparound included:
    sum_v min(d_v, q_v) = rowbase[n] + qbase[q] + sum_{d_v != 0, q_v != 0} t_v,
    t_v = min(d_v, q_v) - min(d_v, 0) - min(0, q_v), rowbase[n] = sum_v
    min(d_v, 0), qbase[q] = sum_v min(0, q_v); t_v is 0 where either side is
    0, so only the buckets a query and a row share add."""
    g = torch.Generator().manual_seed(seed)
    q, n, v = 6, 41, 97
    d, s = _minsum_values(g, (n, v), kind), _minsum_values(g, (q, v), kind)
    d64, s64 = d.to(torch.int64)[None], s.to(torch.int64)[:, None]          # [1, N, V], [Q, 1, V]
    t = torch.minimum(d64, s64) - torch.minimum(d64, torch.zeros_like(d64)) \
        - torch.minimum(torch.zeros_like(s64), s64)
    shared = (d64 != 0) & (s64 != 0)
    assert bool((t[~shared.expand_as(t)] == 0).all())                        # t_v = 0 off the shared
    rowbase = d.to(torch.int64).clamp(max=0).sum(1)                          # [N]
    qbase = s.to(torch.int64).clamp(max=0).sum(1)                            # [Q]
    got = (rowbase[None] + qbase[:, None] + (t * shared).sum(-1)) & 0xFFFFFFFF
    got = torch.where(got > I32.max, got - (1 << 32), got).to(torch.int32)
    assert torch.equal(got, match_minsum(d, s))
    if kind == "wrap":
        wide = torch.minimum(d64, s64).sum(-1)
        assert bool(((wide > I32.max) | (wide < I32.min)).any())             # sums overflow


@pytest.mark.parametrize("q,n,v", [(1, 5, 1), (2, 90, 17), (4, 300, 256), (3, 70, 519)])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.float32])
def test_ip_count_equals_reference_kernel(q, n, v, dtype, rng):
    db = (rng.random((n, v)) < 0.3).astype(dtype)
    qb = (rng.random((q, v)) < 0.3).astype(dtype)
    got = ops.ip_count(_t(db), _t(qb))                   # cast to int8 by the entry
    kernel = np.asarray(jops.ip_count(jnp.asarray(db), jnp.asarray(qb),
                                      tile_q=8, tile_n=128, tile_v=128))
    oracle = np.asarray(jmatch.match_ip(jnp.asarray(db), jnp.asarray(qb)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert np.array_equal(kernel, oracle)
    assert np.array_equal(ref.match_ip(_t(db), _t(qb)).numpy(), oracle)
    d8, q8 = _t(db.astype(np.int8)), _t(qb.astype(np.int8))
    assert torch.equal(ip_count(d8, q8), ip_count_plain(d8, q8))


# V across the steps of the int8 tensor-core tile (csrc/s8_mma_tile.cuh): its
# 32-byte MMA depth and 128-byte stage, COSINE's 238 and a width past 8192;
# Q and N multiples of neither 64 nor 256
DOT_TILE_V = [1, 31, 32, 33, 127, 128, 129, 238, 240, 8195]


@pytest.mark.parametrize("v", DOT_TILE_V)
def test_ip_count_across_the_tile_steps_equals_reference_kernel(v, rng):
    q, n = 67, 301
    db = (rng.random((n, v)) < 0.5).astype(np.int8)
    qb = (rng.random((q, v)) < 0.5).astype(np.int8)
    db[::9] = 0                                          # the engine's pad rows
    got = ip_count(_t(db), _t(qb))
    kernel = np.asarray(jops.ip_count(jnp.asarray(db), jnp.asarray(qb),
                                      tile_q=8, tile_n=128, tile_v=128))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), kernel)
    assert np.array_equal(got.numpy(), qb.astype(np.int64) @ db.astype(np.int64).T)


def test_match_ip_is_exact_past_float32():
    """The plain IP is exact int32 at any V: a dot of 2**24 + 1 ones, where a
    float32 sum (the reference's) would round to 2**24."""
    v = (1 << 24) + 1
    ones = torch.ones((1, v), dtype=torch.int8)
    assert int(ip_count_plain(ones, ones)) == v


def test_wrappers_refuse_what_no_kernel_takes():
    meta32 = torch.empty((10, 7), dtype=torch.int32, device="meta")
    meta8 = torch.empty((10, 7), dtype=torch.int8, device="meta")
    for call in (lambda: range_count(meta32, meta32[:2], meta32[:2]),
                 lambda: minsum_count(meta32, meta32[:2]),
                 lambda: ip_count(meta8, meta8[:2])):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
    common.reset_launch_counts()
    x = torch.zeros((6, 3), dtype=torch.int32)
    ops.range_count(x, x[:2], x[:2])
    ops.minsum_count(x, x[:2])
    ops.ip_count(x, x[:2])
    assert common.launch_counts() == {}                  # the CPU path launches nothing


def test_kernel_sources_share_the_tiles():
    """IP and COSINE run on the int8 tensor-core tile of s8_mma_tile.cuh
    through their own epilogues: no tile body is copied.  That tile issues
    wgmma s8 x s8 -> s32 and no __dp4a.  RANGE has a tile of its own that
    tests on the float16 pipe (saturated adds and an fma per two tests, the
    path picked per block by __syncthreads_and, the int32 path beside it,
    rows past Q staged as the empty range) in the equality tile's frame.
    MINSUM has kernels of its own: the conversion to lists (minsum_nnz,
    minsum_csr: warp ballots) and the count over the lists, which inverts
    chunks of the data in dynamic shared memory with shared atomics only (the
    counts are written with plain stores); its dense tile is eq_tile.cuh's
    through MinColumns."""
    for name, header, body in (("ip_count.cu", "s8_mma_tile.cuh", "dot_tile<Dot, kTma>"),
                               ("cosine_count.cu", "s8_mma_tile.cuh", "dot_tile<Agreements, kTma>")):
        text = (build.CSRC_DIR / name).read_text()
        assert f'#include "{header}"' in text and body in text
        code = re.sub(r"//.*", "", text)
        assert "__shared__" not in code and "__dp4a(" not in code and "wgmma" not in code
    minsum = (build.CSRC_DIR / "minsum_count.cu").read_text()
    code = re.sub(r"//.*", "", minsum)
    assert '#include "eq_tile.cuh"' in minsum
    assert "count_tile<repro::eq_tile::MinColumns>" in code      # the dense tile
    for kernel in ("minsum_nnz_kernel", "minsum_csr_kernel", "minsum_count_kernel",
                   "minsum_count_dense_kernel"):
        assert re.search(kernel + r"<<<", code) or kernel + "," in code   # each launched
    assert "__ballot_sync" in code and "extern __shared__ int4" in code
    assert "__dp4a(" not in code and "wgmma" not in code
    assert set(re.findall(r"atomic\w*\(&?(\w+)\[", code)) == {"cnt_s", "rowbase_s", "row"}
    assert "__shared__" not in code.replace("extern __shared__ int4", "")
    for name, epilogue in (("ip_count.cu", "Dot"), ("cosine_count.cu", "Agreements")):
        text = (build.CSRC_DIR / name).read_text()
        assert f"launch<{epilogue}>" in text         # both loaders' instantiations launched
    mma = re.sub(r"//.*", "", (build.CSRC_DIR / "s8_mma_tile.cuh").read_text())
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n\d+k32\.s32\.s8\.s8", mma)
    assert "__dp4a(" not in mma
    assert "cp.async.bulk.tensor" in mma and "fence.proxy.async" in mma   # the two loaders
    assert not (build.CSRC_DIR / "dp4a_tile.cuh").exists()
    tile = (build.CSRC_DIR / "eq_tile.cuh").read_text()
    min_columns = re.search(r"struct MinColumns \{(.*?)\n\};", tile, re.S).group(1)
    assert "stage_columns<KS>" in min_columns and "return min(a, b);" in min_columns
    assert "RangeColumns" not in tile
    rng = re.sub(r"//.*", "", (build.CSRC_DIR / "range_count.cu").read_text())
    assert "eq_tile.cuh" not in rng and "__syncthreads_and(" in rng
    assert "add.rn.sat.f16x2" in rng and "sub.rn.sat.f16x2" in rng and "fma.rn.f16x2" in rng
    assert "setp.le.and.s32" in rng                      # the int32 path
    assert "make_int2(1, 0)" in rng                      # rows past Q: the empty range
    assert "row[n] = (c > 0 ? row[n] : 0) + lane_sum(" in rng   # runs of 32 counts a warp


# ---------------------------------------------------------------------------
# The MatchModel descriptors
# ---------------------------------------------------------------------------

def test_available_equals_the_reference_registry():
    assert [e.value for e in engines.available()] == [e.value for e in jengines.available()]


@pytest.mark.parametrize("engine", NEW, ids=lambda e: e.value)
def test_match_model_fields_equal_reference(engine, rng):
    model, jmodel = engines.get(engine), jengines.get(JEngine(engine.value))
    assert model.pad_value == jmodel.pad_value and not model.supports_packed
    raw, queries, mc = model.example(np.random.default_rng(3), 40, 5)
    jraw, jqueries, jmc = jmodel.example(np.random.default_rng(3), 40, 5)
    assert mc == jmc and np.array_equal(raw, jraw)
    if engine is Engine.RANGE:
        assert all(np.array_equal(a, b) for a, b in zip(queries, jqueries))
    else:
        assert np.array_equal(queries, jqueries)
    data, jdata = model.prepare_data(raw, torch.device("cpu")), jmodel.prepare_data(raw)
    assert np.array_equal(data.numpy(), np.asarray(jdata))
    assert model.default_max_count(data) == jmodel.default_max_count(jdata)
    assert model.postings_count(data) == jmodel.postings_count(jdata)
    stats, jstats = model.build_stats(data), jmodel.build_stats(jdata)
    for field in ("n_objects", "n_lists", "total_postings", "bytes_device", "extra"):
        assert getattr(stats, field) == getattr(jstats, field), field
    resolved = model.resolve_max_count(data, mc)
    assert resolved == jmodel.resolve_max_count(jdata, mc)
    assert model.count_dtype(resolved) == torch.int8         # 6, 96 and 32 fit a byte
    counts = model.match_counts(data, queries, use_kernel=True)
    assert np.array_equal(counts.numpy(),
                          np.asarray(jmodel.match_counts(jdata, jqueries, use_kernel=False)))
    if mc is None:
        return
    with pytest.raises(ValueError) as ours:
        model.resolve_max_count(data, None)
    with pytest.raises(ValueError) as theirs:
        jmodel.resolve_max_count(jdata, None)
    assert str(ours.value) == str(theirs.value)
    assert "has no derivable count bound; pass max_count explicitly" in str(ours.value)


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.float32, np.int64, np.float64])
def test_ip_keeps_the_callers_dtype_as_the_reference_does(dtype, rng):
    raw = (rng.random((30, 20)) < 0.4).astype(dtype)
    q = (rng.random((4, 20)) < 0.4).astype(dtype)
    idx = GenieIndex.build_ip(raw, max_count=20, device="cpu")
    jidx = JGenieIndex.build_ip(raw, max_count=20)
    assert str(idx.data.dtype).split(".")[-1] == str(jidx.data.dtype)
    assert idx.stats.bytes_device == jidx.stats.bytes_device
    assert idx.stats.total_postings == jidx.stats.total_postings
    for method in METHODS:
        _same(idx.search(q, k=7, method=TopKMethod(method)),
              jidx.search(q, k=7, method=JMethod(method)))


# ---------------------------------------------------------------------------
# The engine matrix on the port (tests/test_engine_matrix.py's single-device
# cases): each engine's example, kernel path vs reference, pads never in top-k
# ---------------------------------------------------------------------------

def _example(engine, seed=0, n=96, q=4):
    model = engines.get(engine)
    raw, queries, mc = model.example(np.random.default_rng(seed), n, q)
    data = model.prepare_data(raw, torch.device("cpu"))
    return model, raw, data, queries, model.resolve_max_count(data, mc)


@pytest.mark.parametrize("engine", NEW, ids=lambda e: e.value)
def test_matrix_search_kernel_reference_parity(engine):
    model, raw, data, queries, mc = _example(engine)
    oracle = jcpq.sort_select(
        jengines.get(JEngine(engine.value)).match_counts(raw, queries, use_kernel=False),
        JSearchParams(k=9, max_count=mc))
    for use_kernel in (False, True):
        idx = GenieIndex.build(engine, data, max_count=mc, use_kernel=use_kernel, device="cpu")
        got = idx.search(queries, k=9)
        assert np.array_equal(got.ids.numpy(), np.asarray(oracle.ids)), use_kernel
        assert np.array_equal(got.counts.numpy(), np.asarray(oracle.counts)), use_kernel


@pytest.mark.parametrize("engine", NEW, ids=lambda e: e.value)
@pytest.mark.parametrize("method", METHODS)
def test_matrix_pad_rows_never_reach_topk(engine, method):
    """The engine's pad fill (INT32_MIN, -1, 0) on the rows past n_objects of
    a padded plan: masked to count -1 before selection, never in the top-k,
    results equal the reference's padded plan and an unpadded search."""
    n = 50
    model, raw, data, queries, mc = _example(engine, n=n)
    seg = SegmentedIndex(engine, max_count=mc, device="cpu")
    jseg = JSegmentedIndex(JEngine(engine.value), max_count=mc)
    for lo, hi in ((0, 43), (43, n)):
        seg.add(raw[lo:hi])
        jseg.add(raw[lo:hi])
    padded, n_obj = seg.concat_data(pad_multiple=56)
    jpadded, _ = jseg.concat_data(pad_multiple=56)
    assert np.array_equal(padded.numpy(), np.asarray(jpadded))
    assert padded[-1, 0].item() == model.pad_value
    q_exec = model.prepare_queries_for(queries, torch.device("cpu"))
    jq = jengines.get(JEngine(engine.value)).prepare_queries(queries)
    for k in (10, 53):                                   # below and above the 50 real rows
        plan = plan_search(engine, k, mc, part_rows=(56,), n_objects=n_obj,
                           method=TopKMethod(method))
        jp = jplan.plan_search(JEngine(engine.value), k, mc, part_rows=(56,), n_objects=n_obj,
                               method=JMethod(method))
        got = execute(plan, padded, q_exec)
        _same(got, jplan.execute(jp, jpadded, jq))
        assert bool((got.counts[got.ids >= n] == -1).all())
        if k <= n:
            assert int(got.ids.max()) < n
            _same(got, GenieIndex.build(engine, raw, max_count=mc, device="cpu").search(
                queries, k=k, method=TopKMethod(method)), threshold=False)


# ---------------------------------------------------------------------------
# GenieIndex.build_* and SegmentedIndex against the reference
# ---------------------------------------------------------------------------

def _corpus(engine, rng, n, q):
    """(raw data, raw queries, max_count) in each engine's own form."""
    if engine is Engine.RANGE:
        x = rng.integers(0, 30, size=(n, 7)).astype(np.int32)
        lo, hi = relational.point_range_queries(x[:q], radius=4, n_bins=30)
        return x, (lo, hi), None
    if engine is Engine.MINSUM:
        seqs = synthetic_sequences(n, length=12, alphabet="abc", seed=int(rng.integers(99)))
        return ngram.count_vectors(seqs, 2, 64), ngram.count_vectors(seqs[:q], 2, 64), 127
    docs = [" ".join(f"w{i}" for i in rng.integers(0, 40, 6)) for _ in range(n)]
    return document.binary_vectors(docs, 128), document.binary_vectors(docs[:q], 128), 16


@pytest.mark.parametrize("engine", NEW, ids=lambda e: e.value)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_genie_index_builders_equal_reference(engine, use_kernel, rng):
    data, q, mc = _corpus(engine, rng, 230, 6)
    if engine is Engine.RANGE:
        idx = GenieIndex.build_relational(data, use_kernel=use_kernel, device="cpu")
        jidx = JGenieIndex.build_relational(data)
    elif engine is Engine.MINSUM:
        idx = GenieIndex.build_minsum(data, max_count=mc, use_kernel=use_kernel, device="cpu")
        jidx = JGenieIndex.build_minsum(data, max_count=mc)
    else:
        idx = GenieIndex.build_ip(data, max_count=mc, use_kernel=use_kernel, device="cpu")
        jidx = JGenieIndex.build_ip(data, max_count=mc)
    assert idx.engine is engine and idx.max_count == jidx.max_count
    assert np.array_equal(idx.data.numpy(), np.asarray(jidx.data))
    assert np.array_equal(idx.match_counts(q).numpy(), np.asarray(jidx.match_counts(q)))
    for field in ("n_objects", "n_lists", "total_postings", "bytes_device"):
        assert getattr(idx.stats, field) == getattr(jidx.stats, field), field
    for method, k in (("cpq", 1), ("cpq", 12), ("spq", 12), ("sort", 12)):
        _same(idx.search(q, k=k, method=TopKMethod(method)),
              jidx.search(q, k=k, method=JMethod(method)))


ROWS = [37, 101, 5, 60]                          # uneven, one segment below k


@pytest.mark.parametrize("engine", NEW, ids=lambda e: e.value)
def test_segmented_index_equals_reference_through_a_compaction(engine, rng):
    data, q, mc = _corpus(engine, rng, sum(ROWS), 7)
    segs = {uk: SegmentedIndex(engine, max_count=mc, use_kernel=uk, device="cpu")
            for uk in (True, False)}
    jseg = JSegmentedIndex(JEngine(engine.value), max_count=mc, use_kernel=False)
    start = 0
    for r in ROWS:
        for seg in segs.values():
            seg.add(data[start:start + r])
        jseg.add(data[start:start + r])
        start += r
    wants = {m: jseg.search(q, k=10, method=JMethod(m)) for m in METHODS}
    for seg in segs.values():
        assert seg.segment_rows == jseg.segment_rows == ROWS
        assert seg.max_count == jseg.max_count
        for m in METHODS:
            _same(seg.search(q, k=10, method=TopKMethod(m)), wants[m])
    jseg.compact(max_segments=2)
    for seg in segs.values():
        seg.compact(max_segments=2)
        assert seg.segment_rows == jseg.segment_rows
        for m in METHODS:
            _same(seg.search(q, k=10, method=TopKMethod(m)), wants[m])
        for field in ("n_objects", "total_postings", "bytes_device", "compaction_count"):
            assert getattr(seg.stats, field) == getattr(jseg.stats, field), field


@pytest.mark.parametrize("engine", [Engine.MINSUM, Engine.IP], ids=lambda e: e.value)
def test_first_add_without_a_bound_raises_as_the_reference(engine, rng):
    data, _, _ = _corpus(engine, rng, 20, 2)
    with pytest.raises(ValueError) as ours:
        SegmentedIndex(engine, device="cpu").add(data)
    with pytest.raises(ValueError) as theirs:
        JSegmentedIndex(JEngine(engine.value)).add(data)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="pass max_count explicitly"):
        GenieIndex.build(engine, data, device="cpu")


# ---------------------------------------------------------------------------
# The sequence, document and relational round trips of tests/test_sa.py
# ---------------------------------------------------------------------------

def test_sequence_search_end_to_end():
    """A mutated query finds its source sequence among the K = 32 MINSUM
    candidates, and verification picks it as the top-1; every step equals the
    reference's."""
    seqs = synthetic_sequences(300, length=40, seed=1)
    n, v, K = 3, 4096, 32
    cv = ngram.count_vectors(seqs, n, v)
    idx = GenieIndex.build_minsum(cv, max_count=127, device="cpu")
    jidx = JGenieIndex.build_minsum(cv, max_count=127)
    target = 17
    qstr = mutate_sequence(seqs[target], 0.2, seed=2)
    qv = ngram.count_vector(qstr, n, v)[None]
    res, jres = idx.search(qv, k=K), jidx.search(qv, k=K)
    _same(res, jres)
    cand_ids = res.ids[0].numpy()
    assert target in cand_ids[:K]
    enc, lens = ngram.encode_sequences([seqs[i] if i >= 0 else "" for i in cand_ids], 48)
    qenc, qlen = ngram.encode_sequences([qstr], 48)
    out = verify.verify_topk(_t(qenc[0]), int(qlen[0]), _t(enc), _t(lens), res.counts[0],
                             k=1, n=n)
    from repro.core.sa import verify as jverify
    jout = jverify.verify_topk(jnp.asarray(qenc[0]), jnp.int32(qlen[0]), jnp.asarray(enc),
                               jnp.asarray(lens), jnp.asarray(np.asarray(jres.counts[0])),
                               k=1, n=n)
    for key in jout:
        assert np.array_equal(out[key].numpy(), np.asarray(jout[key])), key
    assert int(cand_ids[int(out["order"][0])]) == target


def test_document_search_inner_product():
    docs = ["the cat sat on the mat", "dogs chase cats", "jax on tpu pods",
            "inverted index similarity search", "cat and dog and bird"]
    v = 2048
    idx = GenieIndex.build_ip(document.binary_vectors(docs, v), max_count=64, device="cpu")
    q = document.binary_vectors(["cat dog"], v)
    res = idx.search(q, k=2)
    want = sorted((document.exact_overlap("cat dog", d) for d in docs), reverse=True)[:2]
    assert res.counts[0].tolist() == want
    _same(res, JGenieIndex.build_ip(jdocument.binary_vectors(docs, v), max_count=64).search(
        jdocument.binary_vectors(["cat dog"], v), k=2))


def test_relational_range_search(rng):
    vals = rng.standard_normal((400, 6))
    disc = relational.fit_discretizer(vals, n_bins=1024)
    dv = disc.transform(vals)
    assert np.array_equal(dv, jrelational.fit_discretizer(vals, n_bins=1024).transform(vals))
    idx = GenieIndex.build_relational(dv, device="cpu")
    lo, hi = relational.point_range_queries(dv[:3], radius=50)
    res = idx.search((lo, hi), k=1)
    assert (res.counts[:, 0] == 6).all()
    assert res.ids[:, 0].tolist() == [0, 1, 2]
    want = relational.exact_range_count(dv, lo, hi)
    assert np.array_equal(ops.range_count(_t(dv), _t(lo), _t(hi)).numpy(), want)
    _same(idx.search((lo, hi), k=5), JGenieIndex.build_relational(dv).search((lo, hi), k=5))
