"""Short-document SA search (paper section V-B).

Documents are broken into words; the match count between binary word vectors
is their inner product (the binary vector-space model), computed by the IP
engine (kernels/ip_count.py).  Stop-word removal mirrors the paper's Tweets pipeline.
"""
from __future__ import annotations

import re
import zlib

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9']+")

STOP_WORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to was were will with".split()
)


def tokenize(doc: str, remove_stop_words: bool = True) -> list[str]:
    words = _WORD_RE.findall(doc.lower())
    if remove_stop_words:
        words = [w for w in words if w not in STOP_WORDS]
    return words


def word_bucket(word: str, n_buckets: int) -> int:
    return zlib.crc32(word.encode("utf-8")) % n_buckets


def binary_vector(doc: str, n_buckets: int, remove_stop_words: bool = True) -> np.ndarray:
    v = np.zeros(n_buckets, dtype=np.int8)
    for w in tokenize(doc, remove_stop_words):
        v[word_bucket(w, n_buckets)] = 1
    return v


def binary_vectors(docs: list[str], n_buckets: int, remove_stop_words: bool = True) -> np.ndarray:
    return np.stack([binary_vector(d, n_buckets, remove_stop_words) for d in docs])


def exact_overlap(a: str, b: str, remove_stop_words: bool = True) -> int:
    """Oracle: |words(a) & words(b)| (binary inner product)."""
    return len(set(tokenize(a, remove_stop_words)) & set(tokenize(b, remove_stop_words)))
