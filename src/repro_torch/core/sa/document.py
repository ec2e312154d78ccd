"""Short-document SA search (paper section V-B).

Documents are broken into words; the match count between binary word vectors
is their inner product (the binary vector-space model), computed by the IP
engine (kernels/ip_count.py).  Stop-word removal mirrors the paper's Tweets pipeline.

Two encoders give the same vectors.  `binary_vectors` reads strings on the
host (numpy).  The device path takes documents as word ids into a
vocabulary: `bucket_table` hashes the vocabulary once, `word_vectors` turns
int32 ids [rows, L] (padded with -1) into int8 vectors on the ids' device in
one scatter.  `DocumentIndex` holds such documents in a
`SegmentedIndex(Engine.IP)`:

    index = DocumentIndex(vocabulary, n_buckets=8192, max_count=24)
    index.add(word_ids)                    # encoded on the device, one segment
    res = index.search(query_ids, k=100)   # TopKResult, (count desc, id asc)

A search is one root span `document.search` holding `encode` and the
index's `index.search` (repro_torch.trace).
"""
from __future__ import annotations

import re
import zlib
from typing import Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.segments import SegmentedIndex
from repro_torch.core.types import Engine, TopKMethod, TopKResult
from repro_torch.device import DeviceLike, resolve_device

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


# ---------------------------------------------------------------------------
# The device path: documents as word ids
# ---------------------------------------------------------------------------

def bucket_table(words: Sequence[str], n_buckets: int,
                 device: DeviceLike = None) -> torch.Tensor:
    """int64 [len(words)]: the bucket `word_bucket(w, n_buckets)` of each
    vocabulary word, -1 for a word of STOP_WORDS.  The words are tokens as
    `tokenize` gives them."""
    return torch.tensor([-1 if w in STOP_WORDS else word_bucket(w, n_buckets) for w in words],
                        dtype=torch.int64, device=resolve_device(device))


def word_vectors(word_ids: torch.Tensor, table: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """int8 {0, 1} [rows, n_buckets] on the ids' device from word ids
    [rows, L] (any integer type, -1 a pad): 1 at the bucket of every word
    that is no stop word, a repeated word once -- `binary_vectors` of the
    same documents spelled out.  One scatter of the value 1; pads and stop
    words are sent to bucket 0, which is then set from the words that are
    really there."""
    buckets = torch.where(word_ids >= 0, table.to(word_ids.device)[word_ids], -1)
    out = torch.zeros((word_ids.shape[0], n_buckets), dtype=torch.int8, device=word_ids.device)
    out.scatter_(1, buckets.clamp(min=0), 1)
    out[:, 0] = (buckets == 0).any(dim=1)
    return out


class DocumentIndex:
    """Short documents given as word ids into `vocabulary`, encoded on the
    device and held in a `SegmentedIndex(Engine.IP)`: a query's count with a
    document is the number of buckets they share.  `device=None` means the
    card."""

    def __init__(self, vocabulary: Sequence[str], n_buckets: int, max_count: int,
                 device: DeviceLike = None):
        self.n_buckets = n_buckets
        self.table = bucket_table(vocabulary, n_buckets, device)
        self.index = SegmentedIndex(Engine.IP, max_count=max_count, device=self.table.device)

    def encode(self, word_ids) -> torch.Tensor:
        """The binary word vectors int8 [rows, n_buckets] of word ids."""
        ids = torch.as_tensor(word_ids).to(self.table.device)
        return word_vectors(ids, self.table, self.n_buckets)

    def add(self, word_ids) -> None:
        """Seal documents (word ids [rows, L], -1 pads) into one segment."""
        self.index.add(self.encode(word_ids))

    def search(self, word_ids, k: int, method: TopKMethod = TopKMethod.CPQ) -> TopKResult:
        """The top k documents of each query (word ids [Q, L], -1 pads)."""
        with trace.span("document.search", k=k):
            with trace.span("encode"):
                queries = self.encode(word_ids)
            return self.index.search(queries, k=k, method=method)
