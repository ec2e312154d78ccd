"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and nvcc (a CUDA kernel has no interpret
mode); they carry the `gpu` marker and skip where there is no device.  This
file imports neither jax nor the JAX package, so it runs on a machine that
holds only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import TopKMethod, packing
from repro_torch.kernels import common, ops
from repro_torch.kernels.cosine_count import cosine_count_plain
from repro_torch.kernels.cpq_hist import cpq_hist_plain
from repro_torch.kernels.match_count import match_count, match_count_plain
from repro_torch.kernels.packed_cosine import (packed_cosine_count_plain,
                                               packed_cosine_topk_plain)
from repro_torch.kernels.packed_tanimoto import (packed_tanimoto_count_plain,
                                                 packed_tanimoto_topk_plain)
from repro_torch.kernels.tanimoto_count import tanimoto_count_plain
from repro_torch.serve import RetrievalService

SHAPES = [(1, 5, 3), (3, 130, 17), (8, 300, 64), (5, 257, 33), (70, 10003, 238)]  # (Q, N, m)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions_on_the_card():
    _need_card()
    gen = torch.Generator().manual_seed(0)
    common.reset_launch_counts()
    for q, n, m in SHAPES:
        d = torch.randint(0, 9, (n, m), generator=gen, dtype=torch.int32).cuda()
        s = torch.randint(0, 9, (q, m), generator=gen, dtype=torch.int32).cuda()
        counts = ops.match_count(d, s)
        assert torch.equal(counts, match_count_plain(d, s))
        masked = counts.clone()
        masked[:, ::5] = -1
        assert torch.equal(ops.cpq_hist(masked, m), cpq_hist_plain(masked, m))
    torch.cuda.synchronize()
    assert common.launch_counts() == {"match_count": 5, "cpq_hist": 5}
    with pytest.raises(TypeError):
        match_count(d.to(torch.int64), s)          # the wrapper raises, no fallback


@pytest.mark.gpu
def test_service_kernel_path_equals_plain_path_on_the_card():
    _need_card()
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((3000, 16)).astype(np.float32)
    results = {}
    for use_kernel in (True, False):
        svc = RetrievalService(m_override=64, use_kernel=use_kernel, max_segments=4)
        for lo in range(0, 3000, 500):
            svc.add(range(lo, lo + 500), embeddings=emb[lo:lo + 500])
        results[use_kernel] = [svc.search(None, k=10, embeddings=emb[::100], method=m)[0]
                               for m in TopKMethod]
    for a, b in zip(results[True], results[False]):
        assert a.ids.is_cuda
        assert torch.equal(a.ids, b.ids) and torch.equal(a.counts, b.counts)
        assert torch.equal(a.threshold, b.threshold)
        assert a.ids[:, 0].tolist() == list(range(0, 3000, 100))


@pytest.mark.gpu
def test_cosine_kernels_equal_plain_versions_on_the_card():
    _need_card()
    gen = torch.Generator().manual_seed(1)
    common.reset_launch_counts()
    for q, n, v in SHAPES:
        d = (torch.randint(0, 2, (n, v), generator=gen, dtype=torch.int8) * 2 - 1).cuda()
        s = (torch.randint(0, 2, (q, v), generator=gen, dtype=torch.int8) * 2 - 1).cuda()
        d[::7] = 0                                 # pad rows floor to V // 2
        assert torch.equal(ops.cosine_count(d, s), cosine_count_plain(d, s))
        dw, sw = packing.pack_signs_data(d), packing.pack_signs_queries(s)
        assert torch.equal(ops.packed_cosine_count(dw, sw), packed_cosine_count_plain(dw, sw))
        for k in (1, 10):
            got = ops.packed_cosine_topk(dw, sw, k=k)
            want = packed_cosine_topk_plain(dw, sw, k)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert common.launch_counts() == {"cosine_count": 5, "packed_cosine_count": 5,
                                      "packed_cosine_topk": 10}


@pytest.mark.gpu
def test_simhash_service_packed_equals_wide_on_the_card():
    _need_card()
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((3000, 16)).astype(np.float32)
    results = {}
    for layout in ("wide", "packed"):
        for use_kernel in (True, False):
            svc = RetrievalService(scheme="simhash", m_override=64, use_kernel=use_kernel,
                                   max_segments=4, signature_layout=layout)
            for lo in range(0, 3000, 500):
                svc.add(range(lo, lo + 500), embeddings=emb[lo:lo + 500])
            results[(layout, use_kernel)] = svc.search(None, k=10, embeddings=emb[::100])[0]
    base = results[("wide", False)]
    for res in results.values():
        assert res.ids.is_cuda
        assert torch.equal(res.ids, base.ids) and torch.equal(res.counts, base.counts)
    assert base.ids[:, 0].tolist() == list(range(0, 3000, 100))


@pytest.mark.gpu
def test_tanimoto_kernels_equal_plain_versions_on_the_card():
    _need_card()
    gen = torch.Generator().manual_seed(2)
    common.reset_launch_counts()
    for q, n, m in SHAPES + [(3, 2100, 600)]:
        d = torch.randint(0, 254, (n, m), generator=gen, dtype=torch.int32).cuda()
        s = torch.randint(0, 254, (q, m), generator=gen, dtype=torch.int32).cuda()
        d[0, 0], s[0, -1] = 0, 253                 # the ends of the packed domain
        assert torch.equal(ops.tanimoto_count(d, s), tanimoto_count_plain(d, s))
        du, su = packing.pack_buckets(d), packing.pack_buckets(s)
        assert torch.equal(ops.packed_tanimoto_count(du, su), packed_tanimoto_count_plain(du, su))
        for k in (1, 10):
            got = ops.packed_tanimoto_topk(du, su, k=k)
            want = packed_tanimoto_topk_plain(du, su, k)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert common.launch_counts() == {"tanimoto_count": 6, "packed_tanimoto_count": 6,
                                      "packed_tanimoto_topk": 12}


@pytest.mark.gpu
def test_minhash_service_packed_equals_wide_on_the_card():
    _need_card()
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((3000, 16)).astype(np.float32)
    results = {}
    for layout in ("wide", "packed"):
        for use_kernel in (True, False):
            svc = RetrievalService(scheme="minhash", m_override=64, n_buckets=254,
                                   use_kernel=use_kernel, max_segments=4,
                                   signature_layout=layout)
            for lo in range(0, 3000, 500):
                svc.add(range(lo, lo + 500), embeddings=emb[lo:lo + 500])
            results[(layout, use_kernel)] = svc.search(None, k=10, embeddings=emb[::100])[0]
    base = results[("wide", False)]
    for res in results.values():
        assert res.ids.is_cuda
        assert torch.equal(res.ids, base.ids) and torch.equal(res.counts, base.counts)
    assert bool((base.counts[:, 0] == 64).all())   # every query finds itself whole


@pytest.mark.gpu
def test_range_minsum_ip_kernels_equal_plain_versions_on_the_card():
    _need_card()
    from repro_torch.kernels.ip_count import ip_count_plain
    from repro_torch.kernels.minsum_count import minsum_count_plain
    from repro_torch.kernels.range_count import range_count_plain

    gen = torch.Generator().manual_seed(3)
    common.reset_launch_counts()
    i32 = torch.iinfo(torch.int32)
    for q, n, d in [(1, 5, 1), (3, 130, 3), (70, 10003, 14), (5, 257, 37)]:
        x = torch.randint(0, 1024, (n, d), generator=gen, dtype=torch.int32)
        x[::5, 0] = i32.min                        # the engine's pad fill
        lo = torch.randint(0, 1024, (q, d), generator=gen, dtype=torch.int32)
        hi = lo + torch.randint(-20, 100, (q, d), generator=gen, dtype=torch.int32)
        lo[0], hi[0] = i32.min, i32.max
        x, lo, hi = x.cuda(), lo.cuda(), hi.cuda()
        assert torch.equal(ops.range_count(x, lo, hi), range_count_plain(x, lo, hi))
    for q, n, v in [(1, 5, 1), (3, 130, 3), (8, 300, 33), (70, 3001, 4096), (5, 2100, 4099)]:
        d = torch.randint(0, 128, (n, v), generator=gen, dtype=torch.int32)
        d[::7] = -1                                # pad rows: negative counts
        s = torch.randint(0, 128, (q, v), generator=gen, dtype=torch.int32)
        d, s = d.cuda(), s.cuda()
        assert torch.equal(ops.minsum_count(d, s), minsum_count_plain(d, s))
    for q, n, v in [(1, 5, 1), (3, 130, 3), (8, 300, 17), (70, 3001, 8192), (5, 2100, 8195)]:
        d = torch.randint(0, 2, (n, v), generator=gen, dtype=torch.int8).cuda()
        s = torch.randint(0, 2, (q, v), generator=gen, dtype=torch.int8).cuda()
        want = ip_count_plain(d, s)
        for dtype in (torch.int8, torch.int32, torch.float32):
            assert torch.equal(ops.ip_count(d.to(dtype), s.to(dtype)), want)
    torch.cuda.synchronize()
    # dense MINSUM data: each call counts the non-zeros of its data and of its
    # queries, then runs the dense tile
    assert common.launch_counts() == {"range_count": 4, "minsum_nnz": 10, "minsum_count": 5,
                                      "ip_count": 15}
    assert common.variant_launch_counts() == {"minsum_count[dense]": 5}


def _int8_on_card(gen, rows, v, lo, hi, offset):
    """A contiguous int8 [rows, v] on the card whose base pointer lies
    `offset` bytes past its allocation's aligned start."""
    buf = torch.randint(lo, hi, (rows * v + offset,), generator=gen, dtype=torch.int8)
    return buf.cuda()[offset:].view(rows, v)


@pytest.mark.gpu
def test_int8_tensor_core_tile_equals_plain_versions_through_both_loaders():
    """cosine_count and ip_count share the wgmma tile of s8_mma_tile.cuh: bit-equal
    to their plain versions through TMA (V a multiple of 16, aligned pointers)
    and through the register loader (V = 238, 8195, and a base pointer that is
    not 16-byte aligned), over the full int8 range, {0, 1} and {-1, 0, +1}."""
    _need_card()
    from repro_torch.kernels.ip_count import ip_count_plain

    gen = torch.Generator().manual_seed(4)
    common.reset_launch_counts()
    seen = set()
    cases = [(67, 301, 32, 0, 0), (67, 1001, 240, 0, 0), (129, 2311, 8192, 0, 0),
             (67, 1001, 238, 0, 0), (33, 777, 8195, 0, 0),
             (67, 1001, 240, 1, 0), (67, 1001, 256, 0, 1)]      # (Q, N, V, offsets)
    for q, n, v, d_off, q_off in cases:
        for lo, hi in ((-128, 128), (0, 2), (-1, 2)):
            d = _int8_on_card(gen, n, v, lo, hi, d_off)
            s = _int8_on_card(gen, q, v, lo, hi, q_off)
            loader = common.dot_tile_loader("ip_count", d, s)
            assert loader == common.dot_tile_loader("cosine_count", d, s)
            assert loader == ("tma" if v % 16 == 0 and d_off == q_off == 0 else "registers")
            seen.add(loader)
            assert torch.equal(ops.cosine_count(d, s), cosine_count_plain(d, s))
            assert torch.equal(ops.ip_count(d, s), ip_count_plain(d, s))
    torch.cuda.synchronize()
    assert seen == {"tma", "registers"}
    assert common.launch_counts() == {"cosine_count": 21, "ip_count": 21}


def _minsum_rows(gen, rows, v, kind):
    """MINSUM operands: "dense" counts 0..127; "fifth" counts 1..127 in a
    fifth of the entries; "sparse" at most 38 non-zero counts a row and every
    7th row all zero; "shared" the sparse pattern with column 0 non-zero in
    every row (one bucket's posting list holds every row); "negative" the
    sparse pattern with values -3..127; "wrap" the sparse pattern near
    INT32_MAX with INT32_MIN in every 5th column, so that sums wrap."""
    i32 = torch.iinfo(torch.int32)
    if kind == "dense":
        return torch.randint(0, 128, (rows, v), generator=gen, dtype=torch.int32)
    if kind == "fifth":
        x = torch.randint(1, 128, (rows, v), generator=gen, dtype=torch.int32)
        return x * (torch.rand((rows, v), generator=gen) < 0.2)
    x = torch.zeros((rows, v), dtype=torch.int32)
    nz = min(38, v)
    lo, hi = {"sparse": (1, 128), "shared": (1, 128), "negative": (-3, 128),
              "wrap": (i32.max - 8, i32.max)}[kind]
    x.scatter_(1, torch.randint(0, v, (rows, nz), generator=gen),
               torch.randint(lo, hi, (rows, nz), generator=gen, dtype=torch.int32))
    x[::7] = 0
    if kind == "shared":
        x[:, 0] = torch.randint(1, 128, (rows,), generator=gen, dtype=torch.int32)
    if kind == "wrap":
        x[:, ::5] = i32.min
    return x


@pytest.mark.gpu
def test_minsum_sparse_kernel_and_dense_tile_equal_plain_version_on_the_card():
    """The sparse MINSUM kernel (with the conversion of its data and its
    queries to lists) and the dense tile, each called directly and through
    the wrapper's pick, bit-equal to the plain version: sparse rows, all-zero
    rows, -1 pad rows, sums that wrap, dense rows; V = 1, 4095, 4096, 4097
    and 9000 (past the index's 4096 buckets)."""
    _need_card()
    from repro_torch.kernels import minsum_count as ms

    gen = torch.Generator().manual_seed(5)
    common.reset_launch_counts()
    want_launches = {"minsum_nnz": 0, "minsum_csr": 0, "minsum_count": 0}
    want_paths = {"minsum_count[inverted]": 0, "minsum_count[dense]": 0}
    for q, n, v in [(1, 5, 1), (67, 3001, 4095), (67, 3001, 4096), (33, 2100, 4097),
                    (9, 1500, 9000)]:
        for kind in ("sparse", "dense", "wrap"):
            d, s = _minsum_rows(gen, n, v, kind), _minsum_rows(gen, q, v, kind)
            d[::9] = -1                                # the engine's pad rows
            d, s = d.cuda(), s.cuda()
            want = ms.minsum_count_plain(d, s)
            assert torch.equal(ops.minsum_count(d, s), want)
            assert torch.equal(ms.minsum_count_sparse(d, s), want)
            assert torch.equal(ms.minsum_count_dense(d, s), want)
            [(offsets, entries, widest)] = ms.minsum_lists(d)
            assert torch.equal(entries, ms.minsum_csr_plain(d))
            assert widest == int(ms.minsum_nnz_plain(d).max())
            assert torch.equal(offsets.diff().to(torch.int32), ms.minsum_nnz_plain(d))
            picks_lists = int((d != 0).sum()) <= ms.DENSE_ABOVE * n * v
            # the wrapper and the sparse call convert the data and the
            # queries; the lists of the data alone
            want_launches["minsum_nnz"] += 2 + 2 + 1
            want_launches["minsum_csr"] += 2 * picks_lists + 2 + 1
            want_launches["minsum_count"] += 3
            want_paths["minsum_count[inverted]"] += 1 + picks_lists
            want_paths["minsum_count[dense]"] += 2 - picks_lists
    torch.cuda.synchronize()
    assert common.launch_counts() == want_launches
    assert common.variant_launch_counts() == want_paths
    # the wrapper took the lists on some calls and the dense tile on others
    assert 45 < want_launches["minsum_csr"] < 75


# (Q, N, V): V = 1, 7, DBLP's 4096 and 9000 (past the index's 4096 buckets,
# so columns share a bucket under their tags); N and Q multiples of neither
# the 256-row chunk nor the 32 queries in flight; V = 30000, where a pad row
# (and a dense row) holds more non-zeros than a chunk's shared memory, so the
# inverted walk refuses the data and the wrapper takes the dense tile
INVERTED_SHAPES = [(1, 5, 1), (33, 1001, 1), (70, 3001, 7), (97, 20003, 4096), (33, 2100, 4096),
                   (9, 1500, 9000), (40, 777, 9000), (5, 300, 30000)]
INVERTED_KINDS = ("sparse", "shared", "negative", "wrap", "fifth", "dense")


@pytest.mark.gpu
def test_minsum_inverted_walk_equals_plain_version_on_the_card():
    """The inverted walk bit-equal to the plain version: rows with no entries,
    one bucket in every row (the longest posting list), -1 pad rows and
    negative query values, values near +-2^31 whose sums wrap, rows a fifth
    non-zero ("fifth", and "wrap" with INT32_MIN in every 5th column) and
    dense rows, inverted a few rows a chunk; at V = 30000, where rows are
    past the shared-memory budget (`row_limit`), the inverted walk refuses
    the data and the wrapper takes the dense tile; the wrapper notes each
    call's path."""
    _need_card()
    from repro_torch.kernels import minsum_count as ms

    gen = torch.Generator().manual_seed(34)
    common.reset_launch_counts()
    calls = {"minsum_count[inverted]": 0, "minsum_count[dense]": 0}
    for q, n, v in INVERTED_SHAPES:
        for kind in INVERTED_KINDS:
            d, s = _minsum_rows(gen, n, v, kind), _minsum_rows(gen, q, v, kind)
            d[5::97] = -1                              # the engine's pad rows
            if kind == "negative":
                s[::3, 0] = -2
            d, s = d.cuda(), s.cuda()
            want = ms.minsum_count_plain(d, s)
            fits = int(ms.minsum_nnz_plain(d).max()) <= ms.row_limit(d.device)
            assert fits == (v < 20000), (q, n, v, kind)   # -1 pad rows past the budget
            if fits:
                assert torch.equal(ms.minsum_count_sparse(d, s), want), (q, n, v, kind)
                calls["minsum_count[inverted]"] += 1
            else:
                with pytest.raises(ValueError, match="past the inverted walk"):
                    ms.minsum_count_sparse(d, s)
            picks_lists = fits and int((d != 0).sum()) <= ms.DENSE_ABOVE * n * v
            assert torch.equal(ops.minsum_count(d, s), want), (q, n, v, kind)
            calls["minsum_count[inverted]"] += picks_lists
            calls["minsum_count[dense]"] += 1 - picks_lists
    torch.cuda.synchronize()
    assert common.variant_launch_counts() == calls


@pytest.mark.gpu
def test_packed_tanimoto_topk_across_count_widths_on_the_card():
    """The fused packed TANIMOTO kernel on either side of its one-byte count
    tile (m = 254 / 255) and of its bins' move to device scratch (m = 503 /
    504), and at m = 1, 238 and 6000, k from 1 to above the tile; both packed
    kernels on rows that are not word-aligned."""
    _need_card()
    gen = torch.Generator().manual_seed(6)
    common.reset_launch_counts()
    cases = [(5, 3000, 1, 1), (70, 10003, 238, 100), (65, 5000, 254, 2100),
             (33, 5000, 255, 10), (3, 2100, 503, 10), (3, 2100, 504, 2500),
             (2, 2100, 6000, 100)]                     # (Q, N, m, k)
    for q, n, m, k in cases:
        d = torch.randint(0, 8, (n, m), generator=gen, dtype=torch.int32).cuda()
        s = torch.randint(0, 8, (q, m), generator=gen, dtype=torch.int32).cuda()
        du, su = packing.pack_buckets(d), packing.pack_buckets(s)
        got = ops.packed_tanimoto_topk(du, su, k=k)
        want = packed_tanimoto_topk_plain(du, su, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # rows whose base lies 1 to 3 bytes past a word boundary: both kernels
    # stage words by funnel shifts from aligned loads
    for off in (1, 2, 3):
        buf = torch.randint(0, 8, (4000 * 238 + off,), generator=gen, dtype=torch.uint8).cuda()
        du, su = buf[off:].view(4000, 238), buf[:238 * 9].view(9, 238)
        assert torch.equal(ops.packed_tanimoto_count(du, su), packed_tanimoto_count_plain(du, su))
        got, want = ops.packed_tanimoto_topk(du, su, k=10), packed_tanimoto_topk_plain(du, su, 10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert common.launch_counts() == {"packed_tanimoto_topk": len(cases) + 3,
                                      "packed_tanimoto_count": 3}


# The equality tile of match_count and tanimoto_count: ids in [0, 31744) take
# its float16 path, a 32-column chunk holding any other id its general path.
LANE_END = 0x7C00
LANE_POOL = [0, 1, 1023, 1024, 2048, 2049, 8191, 31742, 31743]
GENERAL_POOL = [-2**31, -2**31 + 1, -1, 31744, 31745, 65535, 65536, 2**31 - 1]


def _eq_ids(rng, rows, m, kind):
    """int32 ids from a pool of 16: 'lanes' in [0, 31744), 'mixed' the same
    with one general-path id in one row of every third chunk from the second
    on, 'int32' from the whole int32 range."""
    if kind == "int32":
        pool = GENERAL_POOL + rng.integers(-2**31, 2**31 - 1, size=8).tolist()
    else:
        pool = LANE_POOL + rng.integers(0, LANE_END, size=16 - len(LANE_POOL)).tolist()
    ids = np.asarray(pool, dtype=np.int64)[rng.integers(0, len(pool), size=(rows, m))]
    if kind == "mixed":
        for chunk in range(1, -(-m // 32), 3):
            col = 32 * chunk + chunk % min(32, m - 32 * chunk)
            ids[rng.integers(0, rows), col] = GENERAL_POOL[chunk % len(GENERAL_POOL)]
    return torch.from_numpy(ids.astype(np.int32))


@pytest.mark.gpu
def test_equality_tile_both_paths_and_their_borders_on_the_card():
    _need_card()
    rng = np.random.default_rng(7)
    kernels = ((ops.match_count, match_count_plain), (ops.tanimoto_count, tanimoto_count_plain))
    common.reset_launch_counts()
    shapes = [(1, 5, 3), (7, 129, 1), (5, 133, 2), (9, 1001, 63), (70, 10003, 238),
              (3, 301, 4095), (5, 257, 4096), (2, 130, 4097), (3, 131, 8193)]
    for q, n, m in shapes:
        for kind in ("lanes", "mixed", "int32"):
            d, s = _eq_ids(rng, n, m, kind).cuda(), _eq_ids(rng, q, m, kind).cuda()
            s[0] = d[min(1, n - 1)]
            for kernel, plain in kernels:
                assert torch.equal(kernel(d, s), plain(d, s)), (q, n, m, kind)
    # the premise of the float16 path: ids 0..31743 against themselves count
    # m on the diagonal and 0 elsewhere, subnormals included
    ids = torch.arange(LANE_END, dtype=torch.int32, device="cuda")
    for m, rows in ((1, ids[:, None]), (2, torch.stack([ids, LANE_END - 1 - ids], 1))):
        rows = rows.contiguous()
        for kernel, _ in kernels:
            got = kernel(rows, rows)
            assert bool((got.diagonal() == m).all())
            assert int(got.sum(dtype=torch.int64)) == m * LANE_END and int(got.min()) == 0
            del got
    torch.cuda.synchronize()
    assert common.launch_counts() == {"match_count": 27 + 2, "tanimoto_count": 27 + 2}
    with pytest.raises(ValueError):
        ops.match_count(d, s[:, :-1])              # row widths differ
    with pytest.raises(ValueError):
        match_count(d[:, ::2], s[:, ::2])          # not contiguous: the wrapper raises


def _near_complement(rng, q, n, v):
    """Data rows the complement of query 0 with L - 4 + r % 5 signs flipped
    back (L + 1 in every 97th row, a random row in every 37th), L = max(0,
    32W - 254) the one-byte count tile's collapsed end: fewer than 100 rows of
    a tile count above L, so the kernel recounts collapsed entries."""
    s = (rng.integers(0, 2, (q, v)) * 2 - 1).astype(np.int8)
    low = max(0, 32 * (-(-v // 32)) - 254)
    r = np.arange(n)
    flips = np.clip(np.where(r % 97 == 1, low + 1, low - 4 + r % 5), 0, v)
    rank = rng.random((n, v)).argsort(axis=1).argsort(axis=1)
    d = np.where(rank < flips[:, None], s[0], -s[0]).astype(np.int8)
    d[::37] = (rng.integers(0, 2, (len(range(0, n, 37)), v)) * 2 - 1).astype(np.int8)
    return torch.from_numpy(d), torch.from_numpy(s)


@pytest.mark.gpu
def test_packed_cosine_topk_across_count_tiles_on_the_card():
    """The fused COSINE kernel on its one-byte tile at W = 1, 7 (every count
    kept), 8 and 9 (counts <= 32W - 254 stored as 0), on its two-byte tile at
    W = 10, 15, 16 (bins in device scratch from 16 on), 17 and 170; k = 1,
    100 and above the tile; random rows and rows near the complement of a
    query, whose collapsed counts the kernel recounts."""
    _need_card()
    rng = np.random.default_rng(18)
    common.reset_launch_counts()
    cases = [(5, 3000, 1, 10, "random"), (70, 10003, 224, 100, "random"),
             (130, 4500, 238, 1, "random"), (65, 4500, 238, 2500, "random"),
             (9, 4500, 288, 100, "random"), (3, 2100, 289, 100, "random"),
             (5, 2100, 480, 10, "random"), (5, 2100, 481, 10, "random"),
             (9, 4500, 513, 100, "random"), (3, 2100, 5440, 10, "random"),
             (3, 5000, 238, 100, "complement"), (3, 5000, 238, 2500, "complement"),
             (2, 4500, 288, 100, "complement"), (2, 4500, 289, 100, "complement")]
    for q, n, v, k, kind in cases:
        if kind == "random":
            d = torch.from_numpy((rng.integers(0, 2, (n, v)) * 2 - 1).astype(np.int8))
            s = torch.from_numpy((rng.integers(0, 2, (q, v)) * 2 - 1).astype(np.int8))
        else:
            d, s = _near_complement(rng, q, n, v)
        dw = packing.pack_signs_data(d.cuda())
        sw = packing.pack_signs_queries(s.cuda())
        got = ops.packed_cosine_topk(dw, sw, k=k)
        want = packed_cosine_topk_plain(dw, sw, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (q, n, v, k, kind)
    torch.cuda.synchronize()
    assert common.launch_counts() == {"packed_cosine_topk": len(cases)}


@pytest.mark.gpu
def test_cpq_hist_streaming_edges_on_the_card():
    """cpq_hist with 1, 15, 239, 255, 453 / 454 (either side of the
    per-thread counters' limit) and 58,112 bins; whole rows a block (Q fills
    the card) and chunked rows (Q = 1, N = 1,000,003); odd N, so rows start
    off a 16-byte boundary; skewed counts with -1 and past-max_count entries,
    and every entry in one bin."""
    _need_card()
    gen = torch.Generator().manual_seed(19)
    common.reset_launch_counts()
    cases = [(1, 5, 0), (600, 20001, 14), (1, 1_000_003, 14), (70, 100_003, 238),
             (3, 257, 254), (5, 30001, 452), (5, 30001, 453), (2, 10007, 58111)]
    launches = 0
    for q, n, max_count in cases:
        c = torch.randint(-1, max_count + 3, (q, n), generator=gen, dtype=torch.int32)
        c[:, ::3] = max_count // 2
        for counts in (c, torch.full_like(c, max_count)):
            counts = counts.cuda()
            assert torch.equal(ops.cpq_hist(counts, max_count),
                               cpq_hist_plain(counts, max_count)), (q, n, max_count)
            launches += 1
    torch.cuda.synchronize()
    assert common.launch_counts() == {"cpq_hist": launches}


def compact_thresholds(counts: torch.Tensor, max_count: int, cap: int, shift: int) -> torch.Tensor:
    """A threshold a row, in turn from `shift`: -1 (the pad columns tie),
    0, the middle, max_count, the Gate's for k = cap // 2, 1 (the strict
    entries exceed cap) and max_count // 3, the value of a third of every
    row (its ties overflow cap)."""
    from repro_torch.core import cpq

    _, gate = cpq.audit_threshold(cpq_hist_plain(counts, max_count), max(1, cap // 2))
    kinds = [-1, 0, max_count // 2, max_count, None, 1, max_count // 3]
    rows = (torch.arange(counts.shape[0], device=counts.device) + shift) % len(kinds)
    fixed = torch.tensor([-9 if v is None else v for v in kinds], dtype=torch.int32,
                         device=counts.device)[rows]
    return torch.where(fixed == -9, gate, fixed).to(torch.int32)


@pytest.mark.gpu
def test_cpq_compact_equals_plain_version_on_the_card():
    """cpq_compact bit for bit against `_compact_candidates` at Q = 1, 16,
    256, 1024 and N below cap, 4,097, 250,000 and 281,250 (N % 4 = 0, 1, 2,
    so rows start off a 16-byte boundary), with thresholds -1, 0, the
    middle, max_count, the Gate's, one whose strict entries exceed cap and
    one whose ties overflow it, the last 7 columns at -1 as the pad mask
    leaves them; cap 200 (ties in shared memory) and 10,000 (in scratch);
    one block a row at Q = 1024, rows cut into chunks at Q = 1 and 16; and a
    contiguous view whose base is 4 bytes past a 16-byte boundary."""
    _need_card()
    from repro_torch.kernels.cpq_compact import compact_plan, cpq_compact, cpq_compact_plain

    gen = torch.Generator(device="cuda").manual_seed(31)
    max_count = 237
    assert compact_plan(281_250, 1024, 200)[0] == 1
    assert compact_plan(281_250, 1, 200)[0] > 1 and compact_plan(250_000, 16, 200)[0] > 1
    assert compact_plan(281_250, 1024, 10_000) == (1, 1024 * 10_000)
    common.reset_launch_counts()
    launches = 0
    for cap in (200, 10_000):
        for q in (1, 16, 256, 1024):
            for n in (cap - 50, 4097, 250_000, 281_250):
                base = torch.randint(0, max_count + 1, (q + 1, n), generator=gen,
                                     device="cuda", dtype=torch.int32)
                base[:, ::3] = max_count // 3
                base[:, -7:] = -1
                views = [base[:q]] + ([base[1:]] if n % 4 == 1 and q == 16 else [])
                for counts in views:
                    for shift in range(7 if q < 7 else 1):
                        thr = compact_thresholds(counts, max_count, cap, shift)
                        got = cpq_compact(counts, thr, cap)
                        want = cpq_compact_plain(counts, thr, cap)
                        what = (cap, q, n, shift, counts.storage_offset())
                        assert torch.equal(got[0], want[0]), what
                        assert torch.equal(got[1], want[1]), what
                        launches += 1
                del base, views
    torch.cuda.synchronize()
    assert common.launch_counts() == {"cpq_compact": launches}


# range_count's float16 path takes a 16-attribute chunk of a 128-row data tile
# whose values all lie in [-2048, 2048]; -2049 / 2049 and the ends of int32
# send it to the int32 path.  Query bounds around +-2049 (where the float16
# path moves them) and at the ends of int32.
RANGE_LANE_POOL = [-2048, -2047, -1, 0, 1, 1023, 2047, 2048]
RANGE_GENERAL_POOL = [-2**31, -2050, -2049, 2049, 2050, 2**31 - 1]
RANGE_BOUND_POOL = [-2**31, -2050, -2049, -2048, -2047, 0, 2047, 2048, 2049, 2050, 2**31 - 1]


def _pick(gen, pool, shape):
    return torch.tensor(pool, dtype=torch.int64)[torch.randint(0, len(pool), shape,
                                                               generator=gen)]


def _range_operands(gen, q, n, d, kind):
    """int32 (x [n, d], lo, hi [q, d]): "lanes" data in [-2048, 2048] with
    the border values, "mixed" the same with one general value in one row
    of every third 128-row tile, "int32" anywhere; intervals around data
    values, bounds from the pool, lo == hi, all / none / the pad (1, 0)."""
    i32 = torch.iinfo(torch.int32)
    if kind == "int32":
        x = torch.randint(i32.min, i32.max, (n, d), generator=gen, dtype=torch.int64)
        pool = RANGE_LANE_POOL + RANGE_GENERAL_POOL
    else:
        x = torch.randint(-2048, 2049, (n, d), generator=gen, dtype=torch.int64)
        pool = RANGE_LANE_POOL
    x = torch.where(torch.rand((n, d), generator=gen) < 0.4, _pick(gen, pool, (n, d)), x)
    if kind == "mixed":
        for t in range(1, -(-n // 128), 3):
            x[128 * t + (t * 37) % min(128, n - 128 * t), t % d] = \
                RANGE_GENERAL_POOL[t % len(RANGE_GENERAL_POOL)]
    centre = x[torch.randint(0, n, (q,), generator=gen)]
    lo = centre - torch.randint(0, 31, (q, d), generator=gen)
    hi = centre + torch.randint(0, 31, (q, d), generator=gen)
    for b in (lo, hi):
        swap = torch.rand((q, d), generator=gen) < 1 / 3
        b[swap] = _pick(gen, RANGE_BOUND_POOL, (int(swap.sum()),))
    hi[:, ::3] = lo[:, ::3]
    for row, (a, b) in enumerate(((i32.min, i32.max), (i32.max, i32.min), (1, 0))[:q]):
        lo[row], hi[row] = a, b
    return tuple(t.clamp(i32.min, i32.max).to(torch.int32).cuda() for t in (x, lo, hi))


@pytest.mark.gpu
def test_range_count_both_paths_and_their_borders_on_the_card():
    """range_count on both paths of its tile: chunks of 16 attributes (d = 1
    to 37 and 2100, past one flush of its float16 lanes), output rows that
    are and are not 16-byte aligned (N = 1026, 1027, 61,250), Q past one
    128-row tile, and the bounds the float16 path moves."""
    _need_card()
    from repro_torch.kernels.range_count import range_count_plain

    gen = torch.Generator().manual_seed(9)
    common.reset_launch_counts()
    shapes = [(1, 5, 1), (3, 130, 3), (5, 257, 37), (130, 1026, 16), (129, 1027, 17),
              (7, 4099, 33), (200, 61250, 14), (3, 300, 2100)]
    for q, n, d in shapes:
        for kind in ("lanes", "mixed", "int32"):
            x, lo, hi = _range_operands(gen, q, n, d, kind)
            assert torch.equal(ops.range_count(x, lo, hi), range_count_plain(x, lo, hi)), \
                (q, n, d, kind)
    torch.cuda.synchronize()
    assert common.launch_counts() == {"range_count": 3 * len(shapes)}


@pytest.mark.gpu
def test_packed_tanimoto_count_across_chunks_and_flushes_on_the_card():
    """packed_tanimoto_count across its 32-column chunks (m = 31 to 33, 63 to
    65), the flush of its lanes after 127 chunks (m = 4064, 4065, 8200), m =
    1 to 300 and 4096, with one query row equal to a data row (a lane's
    largest count) and ids at the domain's ends, beside tanimoto_count."""
    _need_card()
    gen = torch.Generator().manual_seed(10)
    common.reset_launch_counts()
    shapes = [(3, 70, 1), (2, 90, 5), (3, 301, 31), (130, 301, 32), (5, 129, 33), (3, 200, 63),
              (3, 200, 65), (70, 10003, 238), (2, 200, 300), (3, 1030, 4064), (3, 1030, 4065),
              (2, 700, 4096), (2, 500, 8200)]
    for q, n, m in shapes:
        d = torch.randint(0, 254, (n, m), generator=gen, dtype=torch.int32)
        s = torch.randint(0, 254, (q, m), generator=gen, dtype=torch.int32)
        d[:, 0], s[-1, -1] = 253, 0
        s[0] = d[min(1, n - 1)]
        d, s = d.cuda(), s.cuda()
        du, su = packing.pack_buckets(d), packing.pack_buckets(s)
        got = ops.packed_tanimoto_count(du, su)
        assert torch.equal(got, packed_tanimoto_count_plain(du, su)), (q, n, m)
        assert torch.equal(got, tanimoto_count_plain(d, s)) and int(got[0, min(1, n - 1)]) == m
    torch.cuda.synchronize()
    assert common.launch_counts() == {"packed_tanimoto_count": len(shapes)}


@pytest.mark.gpu
def test_packed_cosine_count_carry_save_tile_on_the_card():
    """The count tile at W = 1 to 17 (one and three trees of eight words),
    Q and N past one block (32 query, 1024 data rows) and ragged, on random,
    all-equal and complementary rows."""
    _need_card()
    gen = torch.Generator().manual_seed(7)
    for q, n, v in [(67, 1025, 32), (65, 2049, 224), (130, 3001, 256), (129, 1023, 288),
                    (3, 1500, 512), (66, 1100, 544), (1, 1, 5)]:
        for kind in ("random", "equal", "complement"):
            d = (torch.randint(0, 2, (n, v), generator=gen, dtype=torch.int8) * 2 - 1).cuda()
            s = (torch.randint(0, 2, (q, v), generator=gen, dtype=torch.int8) * 2 - 1).cuda()
            if kind == "equal":
                d.fill_(1)
                s.fill_(1)
            elif kind == "complement":
                s[:min(q, n)] = -d[:min(q, n)]
            dw, sw = packing.pack_signs_data(d), packing.pack_signs_queries(s)
            got = ops.packed_cosine_count(dw, sw)
            assert torch.equal(got, packed_cosine_count_plain(dw, sw)), (q, n, v, kind)
            if kind == "equal":
                assert bool((got == v).all())
            if kind == "complement":
                assert bool((got.diagonal()[:min(q, n)] == 0).all())


@pytest.mark.gpu
def test_multiload_host_loop_from_pinned_parts_equals_the_device_search():
    """Parts in pinned host memory (copied on a side stream into two reused
    buffers), pageable parts and numpy parts stream to the same result as
    the parts held on the card, for a PACKED simhash index (the packed count
    kernel once a part)."""
    _need_card()
    from repro_torch.core import Engine, SearchParams, SegmentedIndex
    from repro_torch.core.multiload import multiload_search_host
    from repro_torch.core.types import SignatureLayout

    rng = np.random.default_rng(3)
    seg = SegmentedIndex(Engine.COSINE, signature_layout="packed")
    for rows in (700, 1300, 90, 1024):
        seg.add(rng.standard_normal((rows, 100)).astype(np.float32))
    queries = rng.standard_normal((37, 100)).astype(np.float32)
    q_exec = seg.model.prepare_queries_for(queries, seg.device, seg.signature_layout)
    params = SearchParams(k=25, max_count=seg.max_count)
    # a raw match callable: a registry engine would plan its WIDE match
    packed_match = seg.model.match_fn(True, SignatureLayout.PACKED)
    want = seg.search_multiload(queries, k=25)
    resident = [s.data for s in seg.segments]
    for parts in ([p.cpu().pin_memory() for p in resident], [p.cpu() for p in resident],
                  [p.cpu().numpy() for p in resident]):
        common.reset_launch_counts()
        got = multiload_search_host(parts, q_exec, params, packed_match)
        torch.cuda.synchronize()
        assert common.launch_counts() == {"packed_cosine_count": 4, "cpq_hist": 4,
                                          "cpq_compact": 4}
        assert torch.equal(got.ids, want.ids) and torch.equal(got.counts, want.counts)
        assert torch.equal(got.threshold, want.threshold)
    fused = seg.search(queries, k=25)
    assert torch.equal(fused.ids, want.ids) and torch.equal(fused.counts, want.counts)


@pytest.mark.gpu
def test_multiload_host_loop_copies_wait_for_earlier_work_on_freed_memory():
    """The side stream's first copy into a part buffer is ordered after the
    work already enqueued on the caller's stream: memory that a slow pending
    kernel still writes, freed just before the search and handed back by the
    allocator as a part buffer, is not filled until that kernel has run, so
    the pinned parts stream to the same result as the parts on the card."""
    _need_card()
    from repro_torch.core import Engine, SearchParams
    from repro_torch.core.multiload import multiload_search_host

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(5)
    rows, m, n_parts = 4096, 64, 4
    resident = [torch.randint(0, 16, (rows, m), generator=gen, device=device,
                              dtype=torch.int32) for _ in range(n_parts)]
    queries = resident[1][:50].clone()
    params = SearchParams(k=10, max_count=m)
    want = multiload_search_host(resident, queries, params, Engine.EQ)
    pinned = [p.cpu().pin_memory() for p in resident]
    for _ in range(3):
        torch.cuda.synchronize()
        stale = [torch.empty((rows, m), dtype=torch.int32, device=device) for _ in range(2)]
        torch.cuda._sleep(200_000_000)          # ~0.1 s on the caller's stream
        for t in stale:
            t.fill_(-5)                         # runs after the sleep
        del stale                               # freed with the fills still pending
        got = multiload_search_host(pinned, queries, params, Engine.EQ)
        assert torch.equal(got.ids, want.ids) and torch.equal(got.counts, want.counts)
        assert torch.equal(got.threshold, want.threshold)


def _cold_hot_segments(engine, rng, rows=(3000, 2500, 4000, 1700), m=64):
    """An EQ / TANIMOTO corpus whose segments hold disjoint bucket ranges,
    so a query batch drawn from segment 1 rules the others out."""
    from repro_torch.core import SegmentedIndex

    seg = SegmentedIndex(engine)
    for i, n in enumerate(rows):           # ids up to 230: PACKED TANIMOTO takes them
        seg.add(rng.integers(60 * i, 60 * i + 50, (n, m)).astype(np.int32))
    queries = rng.integers(60, 110, (40, m)).astype(np.int32)
    return seg, queries


@pytest.mark.gpu
def test_routed_search_on_the_card_equals_the_full_scan():
    """ROUTED_VERIFIED equals NONE on the card, for EQ and TANIMOTO (WIDE
    and PACKED), on SEGMENTED and the host loop; the skipped segments'
    match kernels never launch."""
    _need_card()
    from repro_torch.core import Engine

    rng = np.random.default_rng(7)
    for engine, layout, kernel in ((Engine.EQ, "wide", "match_count"),
                                   (Engine.TANIMOTO, "wide", "tanimoto_count"),
                                   (Engine.TANIMOTO, "packed", "packed_tanimoto_topk")):
        seg, queries = _cold_hot_segments(engine, rng)
        if layout == "packed":
            from repro_torch.core import SegmentedIndex
            packed = SegmentedIndex(engine, signature_layout="packed")
            for s in seg.segments:
                packed.add(s.data)
            seg = packed
        for name in ("search", "search_multiload"):
            search = getattr(seg, name)
            full = search(queries, k=20)
            common.reset_launch_counts()
            got = search(queries, k=20, routing="routed_verified", nprobe=1)
            torch.cuda.synchronize()
            launches = common.launch_counts()
            assert torch.equal(got.ids, full.ids) and torch.equal(got.counts, full.counts)
            assert torch.equal(got.threshold, full.threshold)
            count = "packed_tanimoto_count" if (layout == "packed"
                                               and name == "search_multiload") else kernel
            assert launches.get(count) == 1, (engine, layout, name, launches)
            assert int(got.ids.min()) >= 3000 and int(got.ids.max()) < 5500


@pytest.mark.gpu
def test_routed_host_loop_copies_only_the_selected_parts():
    """The routed host loop over pinned parts copies the selected parts and
    nothing else (`plan.copied_bytes`), and equals the resident search."""
    _need_card()
    from repro_torch.core import Engine, plan

    rng = np.random.default_rng(8)
    seg, queries = _cold_hot_segments(Engine.EQ, rng)
    pinned = [s.data.cpu().pin_memory() for s in seg.segments]
    q = seg.model.prepare_queries(queries, seg.device)
    want = seg.search_multiload(queries, k=15, routing="routed", nprobe=1)
    for routing, copied in (("routed", pinned[1].numel() * 4),
                            ("none", sum(p.numel() * 4 for p in pinned))):
        p = plan.plan_search(Engine.EQ, 15, seg.max_count, layout="multiload",
                             part_rows=tuple(seg.segment_rows), n_objects=seg.n_objects,
                             host_loop=True, routing=routing, nprobe=1)
        plan.reset_copied_bytes()
        got = plan.execute(p, pinned, q, router=seg.router())
        torch.cuda.synchronize()
        assert plan.copied_bytes() == copied, routing
        if routing == "routed":
            assert torch.equal(got.ids, want.ids) and torch.equal(got.counts, want.counts)


@pytest.mark.gpu
def test_frontend_on_the_card_equals_serial_searches():
    """Coalesced front-end dispatches on the card equal serial searches bit
    for bit, the dispatch thread launches with the service's device current,
    and a warm dispatch builds nothing and repeats its launches."""
    _need_card()
    from repro_torch.kernels import build
    from repro_torch.serve import ServingFrontend

    rng = np.random.default_rng(9)
    emb = rng.standard_normal((4000, 16)).astype(np.float32)
    svc = RetrievalService(m_override=64)
    for lo in range(0, 4000, 1000):
        svc.add(range(lo, lo + 1000), embeddings=emb[lo:lo + 1000])
    seen = []
    search = svc.search

    def spy(*args, **kw):
        seen.append((torch.cuda.current_device(), threading.current_thread().name))
        return search(*args, **kw)

    svc.search = spy
    queries = torch.from_numpy(emb[::50] + 0.01).cuda()
    fe = ServingFrontend(max_wait_us=0, start=False)
    try:
        fe.register("t", svc)
        slices = [(0, 7, 5), (7, 30, 10), (30, 80, 3), (3, 9, 16)]
        futs = [fe.submit("t", None, k=k, embeddings=queries[lo:hi]) for lo, hi, k in slices]
        fe.start()
        results = [f.result(timeout=120) for f in futs]
        builds = []
        real_build = build.build
        build.build = lambda: builds.append(1) or real_build()
        try:
            launches = []
            for _ in range(2):
                common.reset_launch_counts()
                fe.search("t", None, k=10, embeddings=queries[:16], timeout=120)
                torch.cuda.synchronize()
                launches.append(common.launch_counts())
        finally:
            build.build = real_build
    finally:
        fe.close(timeout=120)
    assert fe.stats()["dispatches"] < len(slices) + 2
    assert {d for d, _ in seen} == {svc.device.index or 0}
    assert {t for _, t in seen} == {"serving-frontend"}
    assert launches[0] == launches[1] == {"match_count": 4, "cpq_hist": 4,
                                          "cpq_compact": 4} and builds == []
    for (lo, hi, k), (got, _) in zip(slices, results):
        want, _ = search(None, k=k, embeddings=queries[lo:hi])
        assert np.array_equal(got.ids, want.ids.cpu().numpy())
        assert np.array_equal(got.counts, want.counts.cpu().numpy())


@pytest.mark.gpu
def test_block_shape_variants_equal_plain_versions_at_ragged_shapes_on_the_card():
    """Each block shape a tile knob selects -- the equality tile's 128- and
    32-query-row shapes, the fused top-k kernels' 2048- and 1024-row tiles --
    equals its plain version at ragged Q and N, through its own C entry and
    through the wrapper's pick; the shape launched is counted apart."""
    _need_card()
    gen = torch.Generator().manual_seed(12)
    common.reset_launch_counts()
    for q, n, m in [(1, 1001, 63), (31, 257, 4097), (33, 1029, 33), (70, 3001, 238)]:
        d = torch.randint(0, 30000, (n, m), generator=gen, dtype=torch.int32).cuda()
        s = d[torch.randint(0, n, (q,), generator=gen)].clone()
        s[:, ::3] = torch.randint(0, 30000, s[:, ::3].shape, generator=gen, dtype=torch.int32).cuda()
        for name, plain in (("match_count", match_count_plain),
                            ("tanimoto_count", tanimoto_count_plain)):
            want = plain(d, s)
            for tq, entry in ((128, name), (32, f"{name}_q32")):
                got = common.launch_count(name, d, s, n, q, m, entry=entry, variant=f"tile_q={tq}")
                assert torch.equal(got, want), (name, tq, q, n, m)
            assert torch.equal(getattr(ops, name)(d, s, tile_q=8), want)
    for q, n, v, k in [(3, 1025, 238, 5), (33, 5000, 288, 100), (65, 2047, 64, 1500)]:
        dw = packing.pack_signs_data((torch.randint(0, 2, (n, v), generator=gen,
                                                    dtype=torch.int8) * 2 - 1).cuda())
        sw = packing.pack_signs_queries((torch.randint(0, 2, (q, v), generator=gen,
                                                       dtype=torch.int8) * 2 - 1).cuda())
        du = torch.randint(0, 6, (n, v), generator=gen, dtype=torch.uint8).cuda()
        su = torch.randint(0, 6, (q, v), generator=gen, dtype=torch.uint8).cuda()
        for name, data, query, plain in (
                ("packed_cosine_topk", dw, sw, packed_cosine_topk_plain),
                ("packed_tanimoto_topk", du, su, packed_tanimoto_topk_plain)):
            for tn in (2048, 1024):
                entry = name if tn == 2048 else f"{name}_n1024"
                ids, cnts = common.launch_fused_topk(name, data, query, data.device, n, q,
                                                     data.shape[1], k, tn, entry=entry)
                pids, pcnts = plain(data, query, k, tn)
                assert torch.equal(ids, pids) and torch.equal(cnts, pcnts), (name, tn, q, n)
                ids, cnts = getattr(ops, name)(data, query, k=k, tile_n=tn)
                want = tn if n > 1024 else 1024
                assert ids.shape[1] == -(-n // want) * min(k, want)
    torch.cuda.synchronize()
    shapes = common.variant_launch_counts()
    assert shapes["match_count[tile_q=32]"] == 4 + 4 and shapes["match_count[tile_q=128]"] == 4
    assert shapes["packed_cosine_topk[tile_n=1024]"] == 3 + 3
    assert shapes["packed_tanimoto_topk[tile_n=2048]"] == 3 + 3


@pytest.mark.gpu
def test_tuned_search_on_the_card_equals_the_default_search():
    """A tuned entry (the 32-query-row shape, the 1024-row fused tile, the
    host-loop layout) changes no bit of a search on the card; tune() itself
    measures on the card and its entry keeps the results."""
    _need_card()
    from repro_torch.core import Engine, SegmentedIndex, autotune

    rng = np.random.default_rng(13)
    for engine, layout, data, tiles in (
            (Engine.EQ, "wide", rng.integers(0, 50, (6000, 64)).astype(np.int32),
             (("tile_n", 128), ("tile_q", 8))),
            (Engine.COSINE, "packed", rng.standard_normal((6000, 96)).astype(np.float32),
             (("tile_n", 1024), ("tile_q", 8)))):
        seg = SegmentedIndex(engine=engine, signature_layout=layout)
        for lo in range(0, 6000, 1500):
            seg.add(data[lo:lo + 1500])
        queries = data[::97] + (0.01 if engine is Engine.COSINE else 0)
        base = seg.search(queries, k=20)
        cache = autotune.AutotuneCache()
        for mode in ("segmented", "multiload_host"):
            cache.put(autotune.TunedEntry(
                engine=engine.value, signature_layout=layout,
                n_bucket=autotune.shape_bucket(6000),
                w_bucket=autotune.shape_bucket(seg.segments[0].data.shape[1]),
                tile_overrides=tiles, layout=mode, speedup=1.1))
            common.reset_launch_counts()
            got = seg.search(queries, k=20, autotune=cache)
            torch.cuda.synchronize()
            assert torch.equal(got.ids, base.ids) and torch.equal(got.counts, base.counts)
            assert torch.equal(got.threshold, base.threshold)
            if engine is Engine.EQ:
                assert common.variant_launch_counts() == {"match_count[tile_q=32]": 4}
            elif mode == "segmented":
                assert common.variant_launch_counts() == {"packed_cosine_topk[tile_n=1024]": 4}
    svc = RetrievalService(m_override=64)
    emb = rng.standard_normal((4000, 16)).astype(np.float32)
    svc.add(range(4000), embeddings=emb)
    before, _ = svc.search(None, k=10, embeddings=emb[::40])
    entry = svc.tune(None, k=10, embeddings=emb[::40], budget=4, repeats=2, save=False)
    after, _ = svc.search(None, k=10, embeddings=emb[::40])
    assert entry.speedup >= 1.0 and svc.autotune.fingerprint["platform"] == "cuda"
    assert torch.equal(before.ids, after.ids) and torch.equal(before.counts, after.counts)


@pytest.mark.gpu
def test_a_shape_over_the_shared_memory_budget_is_never_a_candidate():
    """The budget is the card's opt-in shared memory a block; a fused tile
    whose block asks for more than a given budget is not among the
    candidates (and the default one fits the card's)."""
    _need_card()
    from repro_torch.core import autotune

    props = torch.cuda.get_device_properties(0)
    assert autotune.smem_budget_bytes() == props.shared_memory_per_block_optin
    wide = ops.variant_smem("packed_cosine_topk", {"tile_q": 64, "tile_n": 2048}, 8)
    narrow = ops.variant_smem("packed_cosine_topk", {"tile_q": 64, "tile_n": 1024}, 8)
    assert narrow < wide <= autotune.smem_budget_bytes()
    assert autotune.tile_candidates("tile_n", 281250, "packed_cosine_topk", width=8) == [128, 2048]
    assert autotune.tile_candidates("tile_n", 281250, "packed_cosine_topk", width=8,
                                    smem_budget=wide - 1) == [128]


DIST_CASES = [("eq", "wide", "match_count"), ("range", "wide", "range_count"),
              ("minsum", "wide", "minsum_count"), ("ip", "wide", "ip_count"),
              ("cosine", "wide", "cosine_count"), ("cosine", "packed", "packed_cosine_count"),
              ("tanimoto", "wide", "tanimoto_count"),
              ("tanimoto", "packed", "packed_tanimoto_count")]


@pytest.mark.gpu
def test_distributed_layout_on_one_nccl_rank_equals_the_segmented_search():
    """chip_smoke.py's phase 4k (i) at a smaller size: on a one-rank NCCL
    mesh, flat and pod (whose hierarchical plans run the two-level merge),
    every engine and layout, both paths and CPQ / SPQ / SORT over data
    padded to a multiple of 8, the DISTRIBUTED search equals the SEGMENTED
    one (SPQ: the padded data as one host-loop part, whose pad rows its
    range narrowing sees, as in the JAX package), launches the engine's count
    kernel once on the kernel path, and ROUTED_VERIFIED at nprobe 1 equals
    NONE."""
    _need_card()
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core import Engine, SegmentedIndex, distributed, engines, plan
    from repro_torch.launch import mesh as mesh_lib

    if dist.is_initialized() and "nccl" not in str(dist.get_backend()):
        dist.destroy_process_group()        # a CPU test's gloo group: a CUDA mesh needs NCCL
    started = not dist.is_initialized()
    cuda = torch.device("cuda", torch.cuda.current_device())
    rows = [200, 71, 150, 29, 153]           # 603: five pad rows to 608
    try:
        meshes = {"flat": mesh_lib.make_mesh((1,), ("data",)),
                  "pod": mesh_lib.make_mesh((1, 1, 1), ("pod", "data", "model"))}
        for name, layout, kernel in DIST_CASES:
            model = engines.get(name)
            raw, queries, mc = model.example(np.random.default_rng(17), sum(rows), 9)
            q_wide = model.prepare_queries(queries, cuda)
            q_exec = model.pack_queries(q_wide) if layout == "packed" else q_wide
            for use_kernel in (True, False):
                index = SegmentedIndex(Engine(name), max_count=mc, use_kernel=use_kernel,
                                       device=cuda, signature_layout=layout)
                lo = 0
                for r in rows:
                    index.add(raw[lo:lo + r])
                    lo += r
                data, n = index.concat_data(pad_multiple=8)
                assert data.shape[0] == 608 and n == 603
                for method in TopKMethod:
                    want = index.search(queries, k=12, method=method)
                    if method is TopKMethod.SPQ:
                        one = plan.plan_search(name, 12, index.max_count, layout="multiload",
                                               part_rows=(608,), n_objects=n, host_loop=True,
                                               method=method, use_kernel=use_kernel,
                                               signature_layout=layout)
                        want = plan.execute(one, [data], q_exec)
                    for merge, mesh in meshes.items():
                        placed = distribute_tensor(data, mesh, distributed.data_sharding(mesh),
                                                   src_data_rank=None)
                        kw = dict(layout="distributed", n_objects=n, method=method,
                                  use_kernel=use_kernel, hierarchical=merge == "pod",
                                  mesh_axes=mesh.mesh_dim_names, signature_layout=layout)
                        p = plan.plan_search(name, 12, index.max_count, **kw)
                        common.reset_launch_counts()
                        got = plan.execute(p, placed, q_exec, mesh=mesh)
                        torch.cuda.synchronize()
                        launches = common.launch_counts()
                        what = (name, layout, use_kernel, method, merge)
                        assert torch.equal(got.ids, want.ids), what
                        assert torch.equal(got.counts, want.counts), what
                        assert torch.equal(got.threshold, want.threshold), what
                        assert (launches.get(kernel) == 1) if use_kernel else launches == {}, \
                            (what, launches)
                        p = plan.plan_search(name, 12, index.max_count, routing="routed_verified",
                                             nprobe=1, **kw)
                        ver = plan.execute(p, placed, q_exec, mesh=mesh, router=index.router(),
                                           route_queries=q_wide)
                        assert torch.equal(ver.ids, got.ids) and torch.equal(ver.counts, got.counts)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-360m-smoke", "qwen2-moe-a2.7b-smoke"])
def test_decode_step_equals_teacher_forced_forward_on_the_card(arch):
    """chip_smoke.py phase 6d at smoke size: prefill + one decode step on the
    card equal a teacher-forced forward at that position (the reference's
    5e-2), and the decode logits equal the same run on the CPU."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_api, get_config

    _need_card()
    cfg = get_config(arch)
    if cfg.family == "moe":  # capacity dropping is population-dependent
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    api = get_api(cfg)
    batch = SyntheticTokens(cfg, DataConfig(global_batch=2, seq_len=16)).batch(0)
    steps = {}
    for dev in ("cuda", "cpu"):
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        params = _tree_to(params, dev)
        toks = torch.from_numpy(batch["tokens"]).to(dev)
        last, cache, pos = api.prefill(cfg, params, {"tokens": toks}, cache_cap=32)
        nt = torch.argmax(last, -1)[:, None].to(torch.int32)
        step, _ = api.decode_step(cfg, params, nt, cache, pos)
        full, _, _ = api.train_logits(cfg, params, {"tokens": torch.cat([toks, nt], 1)})
        assert float((step - full[:, pos]).abs().max()) < 5e-2, dev
        steps[dev] = step.cpu()
    assert float((steps["cuda"] - steps["cpu"]).abs().max()) < 5e-2


@pytest.mark.gpu
def test_sharded_trainer_on_one_nccl_rank_equals_the_plain_trainer():
    """chip_smoke.py phase 8a at smoke size: a Trainer over a one-rank NCCL
    mesh's state shardings (every leaf a DTensor, every hint dispatched)
    gives the plain Trainer's losses for 2 steps (within 1e-4) and a state
    of DTensors on the card."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shapes, sharding
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.train import Trainer, TrainerConfig, TrainHParams
    from repro_torch.train import step as tsl
    from repro_torch.tree import leaves

    _need_card()
    if dist.is_initialized() and "nccl" not in str(dist.get_backend()):
        dist.destroy_process_group()        # a CPU test's gloo group: a CUDA mesh needs NCCL
    started = not dist.is_initialized()
    cfg = get_config("smollm-360m-smoke")
    api = get_api(cfg)
    hp = TrainHParams(total_steps=2, warmup_steps=1)
    data = DataConfig(global_batch=4, seq_len=64)
    try:
        mesh = mesh_lib.make_local_mesh(1)
        pshapes = shapes.param_specs(cfg, api)
        ssh = sharding.state_shardings(tsl.TrainState(pshapes, None, None),
                                       sharding.params_shardings(pshapes, mesh, cfg.use_tp), mesh)
        runs = {}
        for name, sh in (("plain", None), ("sharded", ssh)):
            t = Trainer(cfg, api, hp, TrainerConfig(total_steps=2, log_every=1), data,
                        shardings=sh)
            runs[name] = ([r["loss"] for r in t.run()], t.final_state)
        assert all(isinstance(p, DTensor) and p.device.type == "cuda"
                   for p in leaves(runs["sharded"][1].params))
        assert np.allclose(runs["sharded"][0], runs["plain"][0], atol=1e-4, rtol=0), runs
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
