"""Sequence decomposition for SA search (paper section V-A).

A sequence S is decomposed into ordered n-grams (gram, i) -- the i-th
occurrence of that gram (Example 5.1).  With ordered grams the match count is
MC(G(S), G(Q)) = sum_g min(c_S(g), c_Q(g))  (Lemma 5.1), which we compute on
device as a MINSUM over per-gram-type count vectors hashed into V buckets.

Bucketisation property (used by the filter): if gram types collide in a
bucket, min(a1+a2, b1+b2) >= min(a1,b1) + min(a2,b2), so the bucketised count
is an UPPER bound on the exact MC.  Theorem 5.1 admission ("MC >= L - n + 1 -
tau*n") therefore never loses a true candidate through bucketing; spurious
admissions are removed by verification (sa/verify.py).  Property-tested.
"""
from __future__ import annotations

import zlib

import numpy as np

ALPHABET = "abcdefghijklmnopqrstuvwxyz 0123456789"


def ngrams(s: str, n: int) -> list[str]:
    if len(s) < n:
        return []
    return [s[i : i + n] for i in range(len(s) - n + 1)]


def ordered_ngrams(s: str, n: int) -> list[tuple[str, int]]:
    """Ordered n-grams (gram, occurrence-index) of Example 5.1."""
    seen: dict[str, int] = {}
    out = []
    for g in ngrams(s, n):
        k = seen.get(g, 0)
        out.append((g, k))
        seen[g] = k + 1
    return out


def gram_bucket(gram: str, n_buckets: int) -> int:
    """Deterministic gram-type -> bucket hash (crc32; stable across runs)."""
    return zlib.crc32(gram.encode("utf-8")) % n_buckets


def count_vector(s: str, n: int, n_buckets: int, clip: int = 127) -> np.ndarray:
    """Per-bucket gram-type multiplicities (int32 [n_buckets], clipped)."""
    v = np.zeros(n_buckets, dtype=np.int32)
    for g in ngrams(s, n):
        v[gram_bucket(g, n_buckets)] += 1
    return np.minimum(v, clip)


def count_vectors(seqs: list[str], n: int, n_buckets: int) -> np.ndarray:
    return np.stack([count_vector(s, n, n_buckets) for s in seqs])


def exact_match_count(s: str, q: str, n: int) -> int:
    """Dict-based oracle for Lemma 5.1: sum_g min(c_s(g), c_q(g))."""
    cs: dict[str, int] = {}
    for g in ngrams(s, n):
        cs[g] = cs.get(g, 0) + 1
    cq: dict[str, int] = {}
    for g in ngrams(q, n):
        cq[g] = cq.get(g, 0) + 1
    return sum(min(c, cq.get(g, 0)) for g, c in cs.items())


def count_filter_bound(len_q: int, len_s: int, tau: int, n: int) -> int:
    """Theorem 5.1: ed(S, Q) <= tau  ==>  MC >= max(|Q|,|S|) - n + 1 - tau*n."""
    return max(len_q, len_s) - n + 1 - tau * n


def encode_sequences(seqs: list[str], max_len: int, alphabet: str = ALPHABET):
    """Pad-encode strings to int32 [K, max_len] + lengths (for the DP verifier).

    Unknown characters map to a shared id; padding uses -1 (never matches).
    """
    lut = {c: i for i, c in enumerate(alphabet)}
    arr = np.full((len(seqs), max_len), -1, dtype=np.int32)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = s[:max_len]
        lens[i] = len(s)
        for j, ch in enumerate(s):
            arr[i, j] = lut.get(ch, len(alphabet))
    return arr, lens
