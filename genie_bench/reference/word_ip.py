"""Short documents -> IP (the tweets-ip deployment): inputs, plain reference,
least work.  Plain PyTorch; nothing of the program under test.

Inputs from `--seed`: a vocabulary of `vocab_words` words, word i named
"w<i>" (data/pipeline.synthetic_documents' names) except the first
len(stop_words) ranks, which are the stop words; tweets of `min_words` to
`max_words` words (uniform) drawn by a Zipf law of exponent `zipf` over the
ranks, in `segments` adds, as word ids int32 [rows, max_words] padded with
-1, each tweet from counter-based uniforms of its own row (so a query's
source tweet is drawn alone); queries block by block, each a corpus tweet
with round(mutation * length) distinct positions redrawn from the same law.  The deployment drops
the stop words and hashes each other word into one of `n_buckets` buckets
by crc32(word) mod n_buckets (the port's `document.word_bucket`); a
document is the set of its buckets.

The reference never builds a word vector of the corpus: for a tweet with
bucket ids B[j] it marks each bucket's first occurrence (F[j]: no j' < j
with B[j'] = B[j]), so that |buckets(q) & buckets(d)| = #{j : F[j] and q
holds B[j]}, a gather of the query's bucket indicator.  Integer arithmetic:
every count is exact, lo == hi.
"""
from __future__ import annotations

import math
import zlib

import torch

from genie_bench.harness.seeds import derive, generator
from genie_bench.reference.topk import TopkCheck, TopkMerge

# elements of one [queries, rows, words] gather block
_BLOCK = 1 << 28


def vocabulary(cfg: dict) -> list:
    """The words of ranks 0 .. vocab_words - 1: the stop words first."""
    stop = list(cfg["stop_words"])
    return stop + [f"w{i}" for i in range(len(stop), cfg["vocab_words"])]


def inputs(cfg: dict, seed: int, device) -> dict:
    """The bucket table (int64 [vocab_words]: crc32(word) mod n_buckets, -1
    for a stop word) and the Zipf law's CDF over the ranks (float64)."""
    stop, v = set(cfg["stop_words"]), cfg["n_buckets"]
    table = [-1 if w in stop else zlib.crc32(w.encode("utf-8")) % v for w in vocabulary(cfg)]
    ranks = torch.arange(1, cfg["vocab_words"] + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -float(cfg["zipf"]), 0)
    return {"table": torch.tensor(table, dtype=torch.int64, device=device),
            "cdf": cdf / cdf[-1].clone()}


def rows_per_add(cfg: dict) -> int:
    n, s = cfg["n_objects"], cfg["segments"]
    if n % s:
        raise ValueError(f"{s} adds do not divide {n} objects")
    return n // s


def _draw(cfg: dict, inp: dict, u: torch.Tensor) -> torch.Tensor:
    """Word ids int64 drawn by the Zipf law from uniforms `u` (float64)."""
    return torch.searchsorted(inp["cdf"], u, right=True).clamp_(max=cfg["vocab_words"] - 1)


_M32 = (1 << 32) - 1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for x in [0, 2**32), in int64 without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer: a bijection of [0, 2**32) that mixes every bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _uniform(seed: int, stream: str, idx: torch.Tensor) -> torch.Tensor:
    """Uniforms in (0, 1), float64, one for each counter `idx` (int64 in
    [0, 2**32)) of the stream `stream` of the seed: a counter-based draw, so
    any row of the corpus is drawn alone, without the rows before it."""
    key = derive(seed, "tweets", stream)
    h = _mix32(_mix32(idx ^ (key & _M32)) ^ (key >> 32 & _M32))
    return (h.to(torch.float64) + 0.5) / float(1 << 32)


def corpus_rows(cfg: dict, seed: int, inp: dict, rows: torch.Tensor) -> torch.Tensor:
    """The tweets of the corpus rows `rows` (int64): word ids int32
    [len(rows), max_words], -1 pads.  Row r's words are a function of the
    seed and r alone."""
    width = cfg["max_words"]
    rows = rows.to(torch.int64)
    if cfg["n_objects"] * width > _M32:
        raise ValueError("the corpus has more words than a 32-bit counter")
    col = torch.arange(width, dtype=torch.int64, device=rows.device)
    words = _draw(cfg, inp, _uniform(seed, "words", rows[:, None] * width + col))
    span = width - cfg["min_words"] + 1
    length = cfg["min_words"] + (_uniform(seed, "length", rows) * span).to(torch.int64)
    return torch.where(col < length[:, None], words, -1).to(torch.int32)


def corpus_chunk(cfg: dict, seed: int, inp: dict, s: int, device) -> torch.Tensor:
    """The tweets of add `s`: word ids int32 [rows, max_words], -1 pads."""
    per = rows_per_add(cfg)
    return corpus_rows(cfg, seed, inp, torch.arange(s * per, (s + 1) * per, device=device))


def queries(cfg: dict, seed: int, inp: dict, blocks, rows: int, device) -> torch.Tensor:
    """`rows` queries of each block of the query stream, each block from a
    stream of the seed of its own: corpus tweets picked at random, each with
    round(mutation * length) distinct positions among its words redrawn by
    the same law: int32 [len(blocks) * rows, max_words], -1 pads.  Only the
    picked tweets are drawn."""
    width = cfg["max_words"]
    picks, keys, drawn = [], [], []
    for b in blocks:
        g = generator(seed, "queries", b, device=device)
        picks.append(torch.randint(0, cfg["n_objects"], (rows,), generator=g, device=device))
        keys.append(torch.rand((rows, width), generator=g, device=device))
        u = torch.rand((rows, width), generator=g, device=device, dtype=torch.float64)
        drawn.append(_draw(cfg, inp, u))
    docs = corpus_rows(cfg, seed, inp, torch.cat(picks))
    n_edit = torch.round((docs >= 0).sum(dim=1, keepdim=True) * cfg["mutation"])
    # pads sort last, so the first n_edit ranks are positions of words
    rank = torch.cat(keys).masked_fill(docs < 0, 2.0).argsort(dim=1).argsort(dim=1)
    return torch.where(rank < n_edit, torch.cat(drawn).to(torch.int32), docs)


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def buckets(cfg: dict, inp: dict, words: torch.Tensor) -> torch.Tensor:
    """Bucket id int64 [rows, max_words] of every word; n_buckets for a pad
    or a stop word."""
    ids = words.to(torch.int64)
    b = torch.where(ids >= 0, inp["table"][ids.clamp(min=0)], -1)
    return torch.where(b >= 0, b, cfg["n_buckets"])


def first_seen(b: torch.Tensor) -> torch.Tensor:
    """F[r, j] = no j' < j with b[r, j'] == b[r, j], bool [rows, words]."""
    w = b.shape[1]
    earlier = torch.ones((w, w), dtype=torch.bool, device=b.device).tril(-1)
    return ~((b[:, :, None] == b[:, None, :]) & earlier).any(dim=-1)


def indicators(cfg: dict, inp: dict, words: torch.Tensor) -> torch.Tensor:
    """bool [Q, n_buckets + 1]: the buckets each query holds; the last
    column (pads and stop words) is False."""
    b = buckets(cfg, inp, words)
    ind = torch.zeros((b.shape[0], cfg["n_buckets"] + 1), dtype=torch.bool, device=b.device)
    ind.scatter_(1, b, True)
    ind[:, -1] = False
    return ind


def _ip_counts(ind: torch.Tensor, b: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """counts int32 [Q, R] = |buckets(q) & buckets(row)| for rows given as
    bucket ids b and first occurrences `first` [R, words]."""
    out = torch.empty((ind.shape[0], b.shape[0]), dtype=torch.int32, device=b.device)
    step = max(1, _BLOCK // max(1, b.numel()))
    for i in range(0, ind.shape[0], step):
        got = ind[i:i + step][:, b]                        # [q, R, words]
        out[i:i + step] = (got & first[None]).sum(-1, dtype=torch.int32)
    return out


def _passes(cfg: dict, seed: int, inp: dict, device):
    """(offset, bucket ids, first occurrences) of each add's tweets."""
    per = rows_per_add(cfg)
    for s in range(cfg["segments"]):
        b = buckets(cfg, inp, corpus_chunk(cfg, seed, inp, s, device))
        yield s * per, b, first_seen(b)


def evaluate(cfg: dict, seed: int, inp: dict, queries: torch.Tensor, sample: dict,
             work: list | None, device) -> dict:
    """One pass over the corpus: the faults of the checked answers (to the
    query word ids `queries`) and, with `work` (the query word ids of each
    traced search), each search's least work."""
    ind = indicators(cfg, inp, queries.to(device))
    check = TopkCheck(sample["ids"], sample["counts"], sample["threshold"], device)
    v = cfg["n_buckets"]
    holders = torch.zeros(v, dtype=torch.int64, device=device) if work else None
    for offset, b, first in _passes(cfg, seed, inp, device):
        counts = _ip_counts(ind, b, first)
        check.block(offset, counts, counts)
        if holders is not None:
            holders += torch.bincount(b[first & (b < v)], minlength=v)
    out = {"answer_faults": check.faults}
    if work:
        out["least_work"] = [least_work(cfg, indicators(cfg, inp, w.to(device)), holders)
                             for w in work]
    return out


def least_work(cfg: dict, ind: torch.Tensor, holders: torch.Tensor) -> dict:
    """The least operations and bytes one search's answer needs, whatever
    computes it: one integer operation for each (query, tweet, bucket) held
    on both sides (a sparse intersection: holders[v] tweets hold bucket v),
    one compare per object and query to select; the corpus's non-zeros read
    once at ceil(log2 n_buckets) bits each, the queries read once as given
    (word ids int32 [Q, max_words]), the answer written once.  No
    intermediate (the [Q, N] counts, the candidate buffers) counts, nor the
    dense int8 storage of the corpus."""
    q, v, k, n = ind.shape[0], cfg["n_buckets"], cfg["k"], cfg["n_objects"]
    nz = ind[:, :v]
    triples = int((nz.double() @ holders.double()).sum())
    entry = math.ceil(math.log2(v)) / 8
    corpus = int(holders.sum()) * entry
    match = {"ops": triples, "bytes": corpus + int(nz.sum()) * entry}
    search = {"ops": triples + q * n,
              "bytes": corpus + q * cfg["max_words"] * 4 + q * (2 * k + 1) * 4}
    return {"match": match, "search": search}


# ---------------------------------------------------------------------------
# The control
# ---------------------------------------------------------------------------

def control_answers(cfg: dict, seed: int, inp: dict, queries: torch.Tensor, device) -> dict:
    """The reference in the program's place with one guarantee broken: exact
    counts, but ties at the threshold taken in a random order (the paper's
    hash table fills in arrival order) instead of by id."""
    ind = indicators(cfg, inp, queries.to(device))
    top = TopkMerge(cfg["k"], tie_generator=generator(seed, "control-ties", device=device))
    for offset, b, first in _passes(cfg, seed, inp, device):
        top.block(offset, _ip_counts(ind, b, first))
    ids, counts, threshold = top.result()
    return {"ids": ids.cpu(), "counts": counts.cpu(), "threshold": threshold.cpu(),
            "sims": None}
