"""The plain references against brute force at tiny sizes, the top-k
comparison, and the least-work counts on hand-made inputs."""
import zlib

import numpy as np
import pytest
import torch

from genie_bench.harness import peaks
from genie_bench.reference import e2lsh_eq, ngram_minsum
from genie_bench.reference.topk import TopkCheck, TopkMerge, malformed_rows
from genie_bench.tests.tiny import one_thread, tiny_cell  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def fmix32_python(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_fmix32_is_murmur3s_finalizer():
    values = [0, 1, 2, 255, 65535, 65536, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    values += np.random.default_rng(0).integers(0, 1 << 32, 200).tolist()
    got = e2lsh_eq.fmix32(torch.tensor(values, dtype=torch.int64)).tolist()
    assert got == [fmix32_python(v) for v in values]


def test_rehash_wraps_negative_raw_hashes_as_uint32():
    raw = torch.tensor([[-1, -7, 3]])
    seeds = torch.tensor([5, 0xFFFFFFFF, 9])
    want = [fmix32_python(((r & 0xFFFFFFFF) ^ s)) % 67 for r, s in zip([-1, -7, 3], [5, 0xFFFFFFFF, 9])]
    assert e2lsh_eq.rehash(raw, seeds, 67).tolist() == [want]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -12])
    got = e2lsh_eq.round_tf32(x).tolist()
    assert got == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]


def _e2lsh(dim=128, m=64):
    cfg = tiny_cell("sift-e2lsh.batch1024", dim=dim, m=m).cfg
    return cfg, e2lsh_eq.inputs(cfg, 11, CPU)


def test_every_float32_hash_is_one_the_reference_admits():
    """The port's float32 hash of the same points lies in {sig, alt} at
    every entry, and few entries are near a bucket edge."""
    from repro_torch.core.lsh import e2lsh

    cfg, inp = _e2lsh()
    x = torch.randn(4000, cfg["dim"], generator=torch.Generator().manual_seed(3))
    params = e2lsh.params_from_numpy(inp["a"].numpy(), inp["b"].numpy(), inp["seeds"].numpy(),
                                     w=cfg["w"], p=2, n_buckets=cfg["n_buckets"], device="cpu")
    port = e2lsh.hash_points(params, x)
    sig, alt = e2lsh_eq.signatures(cfg, inp, x)
    assert bool(((port == sig) | (port == alt)).all())
    assert float((sig != alt).float().mean()) < 1e-2
    assert float((port == sig).float().mean()) > 0.99


def test_count_bounds_equal_brute_force_with_many_near_entries():
    g = torch.Generator().manual_seed(0)
    s, r, m, d = 7, 50, 9, 5
    qa = torch.randint(0, d, (s, m), generator=g, dtype=torch.int32)
    na = torch.randint(0, d, (r, m), generator=g, dtype=torch.int32)
    qb, nb = qa.clone(), na.clone()
    for a, b in ((qa, qb), (na, nb)):
        near = torch.rand(a.shape, generator=g) < 0.3
        b[near] = torch.randint(0, d, (int(near.sum()),), generator=g, dtype=torch.int32)
    lo, hi = e2lsh_eq._count_bounds((qa, qb), (na, nb), d)
    want_lo = torch.zeros(s, r, dtype=torch.int32)
    want_hi = torch.zeros(s, r, dtype=torch.int32)
    for i in range(s):
        for j in range(r):
            for p in range(m):
                sq = {int(qa[i, p]), int(qb[i, p])}
                sn = {int(na[j, p]), int(nb[j, p])}
                want_lo[i, j] += len(sq) == 1 and sq == sn
                want_hi[i, j] += bool(sq & sn)
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)


def test_eq_counts_equal_a_plain_compare():
    g = torch.Generator().manual_seed(1)
    q = torch.randint(0, 67, (5, 40), generator=g, dtype=torch.int32)
    n = torch.randint(0, 67, (300, 40), generator=g, dtype=torch.int32)
    n[7] = q[2]
    got = e2lsh_eq._eq_counts(q, n, 67)
    assert torch.equal(got, (q[:, None] == n[None]).sum(-1, dtype=torch.int32))
    assert int(got[2, 7]) == 40


def _dblp():
    cfg = tiny_cell("dblp-minsum.batch1024").cfg
    return cfg, ngram_minsum.inputs(cfg, 5, CPU)


def test_gram_table_is_crc32_of_the_gram():
    cfg, inp = _dblp()
    a = len(cfg["alphabet"])
    assert inp["table"][0] == zlib.crc32(b"aaa") % cfg["vocab"]
    assert inp["table"][1 * a * a + 2 * a + 3] == zlib.crc32(b"bcd") % cfg["vocab"]
    assert inp["table"][a * a * a - 1] == zlib.crc32(cfg["alphabet"][-1].encode() * 3) % cfg["vocab"]
    assert inp["table"].shape == (a ** 3,)


def test_minsum_counts_equal_the_ports_count_vectors():
    """sum_v min over `ngram.count_vectors` of the decoded titles (the
    port's own string path) equals the reference's repeat numbering."""
    from repro_torch.core.sa import ngram

    cfg, inp = _dblp()
    titles = ngram_minsum.corpus_chunk(cfg, 5, inp, 0, CPU)[:200]
    queries = ngram_minsum.queries(cfg, 5, inp, [0], 9, CPU)
    text = lambda t: ["".join(cfg["alphabet"][c] for c in row) for row in t.tolist()]
    cv = torch.from_numpy(ngram.count_vectors(text(titles), 3, cfg["vocab"]))
    qv = torch.from_numpy(ngram.count_vectors(text(queries), 3, cfg["vocab"]))
    want = torch.minimum(qv[:, None, :], cv[None, :, :]).sum(-1)
    b = ngram_minsum.buckets(cfg, inp, titles)
    got = ngram_minsum._minsum_counts(ngram_minsum.query_vectors(cfg, inp, queries), b,
                                      ngram_minsum.repeats(b), cfg["max_count"])
    assert torch.equal(got, want.to(torch.int32))
    assert torch.equal(ngram_minsum.query_vectors(cfg, inp, queries), qv.to(torch.int64))


def test_query_titles_are_corpus_titles_with_a_few_letters_redrawn():
    cfg, inp = _dblp()
    pool = ngram_minsum.queries(cfg, 5, inp, [0, 3], 8, CPU)
    corpus = torch.cat([ngram_minsum.corpus_chunk(cfg, 5, inp, s, CPU)
                        for s in range(cfg["segments"])])
    differ = (pool[:, None, :] != corpus[None]).sum(-1).min(dim=1).values
    assert int(differ.max()) <= round(cfg["mutation"] * cfg["title_length"])


# -- the top-k comparison -------------------------------------------------------

def _exact(counts: torch.Tensor, k: int):
    order = sorted(range(counts.shape[1]), key=lambda n: (-int(counts[0, n]), n))[:k]
    ids = torch.tensor([order])
    got = counts[0, order][None]
    return ids, got, got[:, -1]


def _faults(ids, counts, threshold, lo, hi=None):
    check = TopkCheck(ids, counts, threshold, CPU)
    half = lo.shape[1] // 2
    hi = lo if hi is None else hi
    check.block(half, lo[:, half:], hi[:, half:])
    check.block(0, lo[:, :half], hi[:, :half])
    return check.faults


COUNTS = torch.tensor([[3, 7, 5, 7, 1, 5, 5, 0, 2, 6]], dtype=torch.int32)


def test_the_exact_answer_has_no_fault():
    assert _faults(*_exact(COUNTS, 4), COUNTS) == 0


@pytest.mark.parametrize("fault", ["count", "missing", "tie order", "threshold"])
def test_a_wrong_answer_has_faults(fault):
    ids, counts, threshold = _exact(COUNTS, 4)                 # ids 1, 3, 9, 2
    if fault == "count":
        counts = counts.clone()
        counts[0, 3] = 6
    elif fault == "missing":
        ids = torch.tensor([[1, 3, 9, 8]])
        counts = torch.tensor([[7, 7, 6, 2]], dtype=torch.int32)
        threshold = counts[:, -1]
    elif fault == "tie order":
        ids = torch.tensor([[1, 3, 9, 5]])                     # 5 returned before 2
        counts = torch.tensor([[7, 7, 6, 5]], dtype=torch.int32)
    else:
        threshold = threshold + 1
    assert _faults(ids, counts, threshold, COUNTS) + malformed_rows(
        ids.numpy(), counts.numpy(), threshold.numpy(), 10) > 0


def test_an_interval_admits_either_count():
    """Object 0 reads 3 in the reference but may read 7 in a faithful run:
    an answer that counts it 7 passes only where the interval admits 7."""
    ids = torch.tensor([[0, 1, 3, 9]])
    counts = torch.tensor([[7, 7, 7, 6]], dtype=torch.int32)
    hi = COUNTS.clone()
    hi[0, 0] = 7
    assert _faults(ids, counts, counts[:, -1], COUNTS, hi) == 0
    assert _faults(ids, counts, counts[:, -1], COUNTS) > 0
    assert _faults(*_exact(COUNTS, 4), COUNTS, hi) == 0


def test_topk_merge_equals_a_stable_sort():
    g = torch.Generator().manual_seed(2)
    counts = torch.randint(0, 6, (4, 300), generator=g, dtype=torch.int32)
    top = TopkMerge(10)
    for off in range(0, 300, 70):
        top.block(off, counts[:, off:off + 70])
    ids, got, threshold = top.result()
    want = torch.sort(counts, dim=1, descending=True, stable=True)
    assert torch.equal(ids, want.indices[:, :10])
    assert torch.equal(got, want.values[:, :10]) and torch.equal(threshold, got[:, -1])


def test_malformed_rows_counts_each_broken_answer_once():
    ids = np.array([[4, 2, 9], [1, 1, 2], [3, 5, 7], [0, 2, 11]])
    counts = np.array([[9, 9, 1], [5, 4, 3], [5, 6, 7], [3, 2, 1]])
    threshold = np.array([1, 3, 7, 1])
    # rows: tie ids descending; a repeated id; counts rising; id 11 out of range
    assert malformed_rows(ids, counts, threshold, 10) == 4
    assert malformed_rows(np.array([[2, 4, 9]]), counts[:1], threshold[:1], 10) == 0


# -- least work -------------------------------------------------------------------

def test_e2lsh_least_work_counts_collisions_selects_and_projections():
    cfg, inp = _e2lsh(dim=8, m=4)
    queries = torch.randn(3, 8)
    hist = torch.full((4, cfg["n_buckets"]), 2, dtype=torch.int64)
    work = e2lsh_eq.least_work(cfg, inp, queries, hist)
    n, q, k, m, d = cfg["n_objects"], 3, cfg["k"], 4, 8
    assert work["match"]["ops"] == 2 * q * m
    assert work["search"]["ops"] == 2 * q * m + q * n + 2 * q * d * m
    sig_bytes = m * 7 / 8                                      # 67 buckets: 7 bits
    assert work["match"]["bytes"] == (n + q) * sig_bytes
    assert work["search"]["bytes"] == (n * sig_bytes + (q * d + m * d + 2 * m) * 4
                                       + q * (2 * k + 1) * 4 + q * k * 8)


def test_minsum_least_work_counts_the_sparse_intersection():
    cfg, _ = _dblp()
    cfg = dict(cfg, vocab=4, max_count=127, k=2, n_objects=20)
    cq = torch.tensor([[1, 0, 2, 0], [0, 0, 0, 3]])
    holders = torch.tensor([5, 7, 11, 13])
    work = ngram_minsum.least_work(cfg, cq, holders)
    entry = (2 + 7) / 8
    assert work["match"] == {"ops": 5 + 11 + 13, "bytes": (36 + 3) * entry}
    assert work["search"] == {"ops": 29 + 2 * 20, "bytes": 36 * entry + 2 * 4 * 4 + 2 * 5 * 4}


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds({"ops": 67e12, "bytes": 0}) == pytest.approx(1.0)
    assert peaks.least_seconds({"ops": 1, "bytes": 6.7e12}) == pytest.approx(2.0)
