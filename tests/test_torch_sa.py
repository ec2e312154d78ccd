"""The port's Shotgun-and-Assembly modules (`repro_torch.core.sa`) against the
JAX package's on the same inputs, for equality.  `ngram`, `document` and
`relational` are numpy copies of the reference's modules; `verify` is
rewritten in PyTorch (one batched DP row over the candidates, `torch.cummin`,
a stable sort for the tie order) and is held here against the reference's
`lax.scan` / `vmap` / `lax.top_k` version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sa import document as jdocument, ngram as jngram
from repro.core.sa import relational as jrelational, verify as jverify
from repro_torch.core.sa import document, ngram, relational, verify

STRINGS = ["", "a", "ab", "abc", "abcabcabc", "aaaaaaa", "the quick brown fox",
           "Hello, World! it's 42", "zz z zz", "abcdefghij" * 4]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# n-grams (sequences, MINSUM)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_ngram_decomposition_equals_reference(n):
    """Strings shorter than n give no grams; ordered grams count repeats."""
    for s in STRINGS:
        assert ngram.ngrams(s, n) == jngram.ngrams(s, n)
        assert ngram.ordered_ngrams(s, n) == jngram.ordered_ngrams(s, n)
        for q in STRINGS[::3]:
            assert ngram.exact_match_count(s, q, n) == jngram.exact_match_count(s, q, n)
    assert ngram.ngrams("ab", 3) == []


@pytest.mark.parametrize("v", [1, 7, 64, 4096])
def test_count_vectors_equal_reference(v):
    for s in STRINGS:
        for g in ngram.ngrams(s, 3):
            assert ngram.gram_bucket(g, v) == jngram.gram_bucket(g, v)
    got = ngram.count_vectors(STRINGS, 3, v)
    assert got.dtype == np.int32 and np.array_equal(got, jngram.count_vectors(STRINGS, 3, v))


def test_count_vector_clips_at_127():
    s = "a" * 300                                   # 298 copies of one gram
    got = ngram.count_vector(s, 3, 16)
    assert int(got.max()) == 127 and np.array_equal(got, jngram.count_vector(s, 3, 16))
    assert np.array_equal(ngram.count_vector(s, 3, 16, clip=50), jngram.count_vector(s, 3, 16, clip=50))


def test_count_filter_bound_and_encoding_equal_reference():
    for lq, ls, tau, n in [(40, 40, 4, 3), (10, 3, 0, 3), (2, 2, 5, 2), (0, 9, 1, 1)]:
        assert ngram.count_filter_bound(lq, ls, tau, n) == jngram.count_filter_bound(lq, ls, tau, n)
    for max_len in (1, 8, 48):
        a, la = ngram.encode_sequences(STRINGS + ["ABC?"], max_len)
        b, lb = jngram.encode_sequences(STRINGS + ["ABC?"], max_len)
        assert np.array_equal(a, b) and np.array_equal(la, lb)


# ---------------------------------------------------------------------------
# documents (IP) and relational tuples (RANGE)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remove", [True, False])
def test_document_vectors_equal_reference(remove):
    """Stop words, punctuation and case, with and without stop-word removal."""
    docs = STRINGS + ["The cat and THE dog", "it is what it is", "a an the"]
    for d in docs:
        assert document.tokenize(d, remove) == jdocument.tokenize(d, remove)
        for w in document.tokenize(d, False):
            assert document.word_bucket(w, 8192) == jdocument.word_bucket(w, 8192)
        for q in docs[::4]:
            assert document.exact_overlap(d, q, remove) == jdocument.exact_overlap(d, q, remove)
    got = document.binary_vectors(docs, 97, remove)
    assert got.dtype == np.int8 and np.array_equal(got, jdocument.binary_vectors(docs, 97, remove))
    assert document.STOP_WORDS == jdocument.STOP_WORDS
    assert document.tokenize("a an the") == []


def test_relational_equals_reference(rng):
    vals = rng.standard_normal((300, 5)) * [1, 10, 0.1, 3, 1]
    vals[:, 4] = 2.5                                # a constant column: zero span
    for n_bins in (2, 1024):
        disc, jdisc = relational.fit_discretizer(vals, n_bins), jrelational.fit_discretizer(vals, n_bins)
        assert np.array_equal(disc.mins, jdisc.mins) and np.array_equal(disc.maxs, jdisc.maxs)
        dv = disc.transform(vals)
        assert dv.dtype == np.int32 and np.array_equal(dv, jdisc.transform(vals))
        for radius in (0, 3, 50):
            lo, hi = relational.point_range_queries(dv[:7], radius, n_bins)
            jlo, jhi = jrelational.point_range_queries(dv[:7], radius, n_bins)
            assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
            assert np.array_equal(relational.exact_range_count(dv, lo, hi),
                                  jrelational.exact_range_count(dv, lo, hi))


# ---------------------------------------------------------------------------
# verification (edit distance, Algorithm 2, Theorem 5.2)
# ---------------------------------------------------------------------------

def _padded(rng, lens, width, pad):
    out = np.full((len(lens), width), pad, np.int32)
    for i, n in enumerate(lens):
        out[i, :n] = rng.integers(0, 4, n)
    return out


@pytest.mark.parametrize("case", range(12))
def test_edit_distance_equals_reference(case):
    """Random lengths from 0 to the padded width, the query's and the
    candidates' pads distinct; each candidate read at its own length."""
    rng = np.random.default_rng(100 + case)
    width = 16
    la = int(rng.integers(0, width + 1))
    a = _padded(rng, [la], width, -1)[0]
    lens = rng.integers(0, width + 1, size=6).astype(np.int32)
    cands = _padded(rng, lens, width, -2)
    got = verify.edit_distance_one_to_many(_t(a), la, _t(cands), _t(lens))
    want = jverify.edit_distance_one_to_many(jnp.asarray(a), jnp.int32(la), jnp.asarray(cands),
                                             jnp.asarray(lens))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    one = verify.edit_distance(_t(a), la, _t(cands[0]), int(lens[0]))
    assert int(one) == int(jverify.edit_distance(jnp.asarray(a), jnp.int32(la),
                                                 jnp.asarray(cands[0]), jnp.int32(lens[0])))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_verify_topk_ties_and_empty_slots_equal_reference(k):
    """Equal edit distances rank the lower slot first (lax.top_k's order),
    cand_lens == 0 slots sink to the end, and the Theorem 5.2 fields agree."""
    rng = np.random.default_rng(k)
    width = 12
    q = _padded(rng, [9], width, -1)[0]
    base = q[:9].copy()
    lens = np.array([9, 9, 0, 9, 5, 0, 9], np.int32)
    cands = _padded(rng, lens, width, -2)
    cands[0, :9] = cands[3, :9] = cands[6, :9] = base          # three ties at distance 0
    cands[1, :9] = base
    cands[1, 4] = (base[4] + 1) % 4                            # distance 1
    counts = np.array([30, 25, 25, 20, 7, 3, 1], np.int32)
    for n in (2, 3):
        got = verify.verify_topk(_t(q), 9, _t(cands), _t(lens), _t(counts), k=k, n=n)
        want = jverify.verify_topk(jnp.asarray(q), jnp.int32(9), jnp.asarray(cands),
                                   jnp.asarray(lens), jnp.asarray(counts), k=k, n=n)
        assert set(got) == set(want)
        for key in want:
            assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert got["order"].tolist()[:3] == [0, 3, 6][:k]
    if k == 8:
        assert got["edit_distances"].tolist()[-2:] == [10**6, 10**6]   # the empty slots


def test_certificate_theorem52_both_ways():
    """certified_exact iff c_K < |Q| - n + 1 - tau_k * n: true when the last
    candidate's count is low, false when it is high."""
    rng = np.random.default_rng(7)
    q = _padded(rng, [10], 10, -1)[0]
    cands = np.stack([q, _padded(rng, [10], 10, -2)[0]])
    lens = np.array([10, 10], np.int32)
    for last, expect in ((0, True), (8, False)):
        counts = np.array([8, last], np.int32)
        got = verify.verify_topk(_t(q), 10, _t(cands), _t(lens), _t(counts), k=1, n=3)
        want = jverify.verify_topk(jnp.asarray(q), jnp.int32(10), jnp.asarray(cands),
                                   jnp.asarray(lens), jnp.asarray(counts), k=1, n=3)
        assert bool(got["certified_exact"]) is expect
        assert bool(got["certified_exact"]) == bool(want["certified_exact"])
        assert int(got["tau_k"]) == int(want["tau_k"]) == 0
