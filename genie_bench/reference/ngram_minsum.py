"""3-gram -> MINSUM (the dblp-minsum deployment): inputs, plain reference,
least work.  Plain PyTorch; nothing of the program under test.

Inputs from `--seed`: titles of `title_length` symbols drawn uniformly from
`alphabet`, in `segments` adds; queries block by block, each a corpus title
with round(mutation * length) distinct positions redrawn from the alphabet.  The
deployment hashes each 3-gram into one of `vocab` buckets by
crc32(gram) mod vocab (the port's `ngram.gram_bucket`), and a count vector
holds each bucket's multiplicity, clipped at `max_count`.

The reference never builds a count vector of the corpus: for a title with
bucket ids B[j] it numbers the repeats of each bucket (O[j] = #{j' < j :
B[j'] = B[j]}), so that sum_v min(c_title[v], c_query[v]) =
#{j : O[j] < c_query[B[j]]} (paper Lemma 5.1 over buckets).  Integer
arithmetic: every count is exact, lo == hi.
"""
from __future__ import annotations

import math
import zlib

import torch
import torch.nn.functional as F

from genie_bench.harness.seeds import generator
from genie_bench.reference.topk import TopkCheck, TopkMerge

# elements of one [queries, rows, grams] gather block
_BLOCK = 1 << 28


def inputs(cfg: dict, seed: int, device) -> dict:
    """The gram table: bucket int64 [len(alphabet) ** gram] of each gram
    code (the letters' codes read as digits base len(alphabet))."""
    alphabet, n, vocab = cfg["alphabet"], cfg["gram"], cfg["vocab"]
    table = []
    for code in range(len(alphabet) ** n):
        letters = [alphabet[code // len(alphabet) ** (n - 1 - j) % len(alphabet)]
                   for j in range(n)]
        table.append(zlib.crc32("".join(letters).encode("utf-8")) % vocab)
    return {"table": torch.tensor(table, dtype=torch.int64, device=device)}


def rows_per_add(cfg: dict) -> int:
    n, s = cfg["n_objects"], cfg["segments"]
    if n % s:
        raise ValueError(f"{s} adds do not divide {n} objects")
    return n // s


def corpus_chunk(cfg: dict, seed: int, inp: dict, s: int, device) -> torch.Tensor:
    """The titles of add `s`: letter codes int8 [rows, title_length]."""
    g = generator(seed, "titles", s, device=device)
    return torch.randint(0, len(cfg["alphabet"]), (rows_per_add(cfg), cfg["title_length"]),
                         generator=g, device=device, dtype=torch.int8)


def queries(cfg: dict, seed: int, inp: dict, blocks, rows: int, device) -> torch.Tensor:
    """`rows` queries of each block of the query stream, each block from a
    stream of the seed of its own: corpus titles picked at random, each
    with round(mutation * length) distinct positions redrawn from the
    alphabet: int8 [len(blocks) * rows, title_length]."""
    length, letters = cfg["title_length"], len(cfg["alphabet"])
    n_edit = round(cfg["mutation"] * length)
    picks, where, drawn = [], [], []
    for b in blocks:
        g = generator(seed, "queries", b, device=device)
        picks.append(torch.randint(0, cfg["n_objects"], (rows,), generator=g, device=device))
        where.append(torch.rand((rows, length), generator=g, device=device)
                     .argsort(dim=1)[:, :n_edit])
        drawn.append(torch.randint(0, letters, (rows, n_edit), generator=g, device=device,
                                   dtype=torch.int8))
    picks = torch.cat(picks)
    per = rows_per_add(cfg)
    titles = torch.empty((picks.shape[0], length), dtype=torch.int8, device=device)
    for s in range(cfg["segments"]):
        mine = ((picks >= s * per) & (picks < (s + 1) * per)).nonzero().flatten()
        if mine.numel():
            titles[mine] = corpus_chunk(cfg, seed, inp, s, device)[picks[mine] - s * per]
    return titles.scatter_(1, torch.cat(where), torch.cat(drawn))


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def buckets(cfg: dict, inp: dict, titles: torch.Tensor) -> torch.Tensor:
    """Bucket id int64 [rows, grams] of every gram of every title."""
    t = titles.to(torch.int64)
    a, n = len(cfg["alphabet"]), cfg["gram"]
    codes = sum(t[:, j:t.shape[1] - n + 1 + j] * a ** (n - 1 - j) for j in range(n))
    return inp["table"][codes]


def repeats(b: torch.Tensor) -> torch.Tensor:
    """O[r, j] = #{j' < j : b[r, j'] == b[r, j]}, int64 [rows, grams]."""
    g = b.shape[1]
    earlier = torch.ones((g, g), dtype=torch.bool, device=b.device).tril(-1)
    return ((b[:, :, None] == b[:, None, :]) & earlier).sum(-1)


def query_vectors(cfg: dict, inp: dict, titles: torch.Tensor) -> torch.Tensor:
    """Count vectors int64 [Q, vocab] of query titles, clipped."""
    hot = F.one_hot(buckets(cfg, inp, titles), cfg["vocab"]).sum(dim=1)
    return hot.clamp_(max=cfg["max_count"])


def _minsum_counts(cq: torch.Tensor, b: torch.Tensor, o: torch.Tensor, clip: int) -> torch.Tensor:
    """counts int32 [Q, R] = sum_v min(c_row[v], cq[v]) for rows given as
    bucket ids b and repeat numbers o [R, grams]."""
    out = torch.empty((cq.shape[0], b.shape[0]), dtype=torch.int32, device=b.device)
    step = max(1, _BLOCK // max(1, b.numel()))
    cq, o = cq.to(torch.int32), o.to(torch.int32)
    kept = o < clip
    for i in range(0, cq.shape[0], step):
        got = cq[i:i + step][:, b]                         # [q, R, grams]
        out[i:i + step] = ((o[None] < got) & kept[None]).sum(-1, dtype=torch.int32)
    return out


def _passes(cfg: dict, seed: int, inp: dict, device):
    """(offset, bucket ids, repeat numbers) of each add's titles."""
    per = rows_per_add(cfg)
    for s in range(cfg["segments"]):
        b = buckets(cfg, inp, corpus_chunk(cfg, seed, inp, s, device))
        yield s * per, b, repeats(b)


def evaluate(cfg: dict, seed: int, inp: dict, queries: torch.Tensor, sample: dict,
             work: list | None, device) -> dict:
    """One pass over the corpus: the faults of the checked answers (to the
    query titles `queries`) and, with `work` (the query titles of each
    traced search), each search's least work."""
    cq = query_vectors(cfg, inp, queries.to(device))
    check = TopkCheck(sample["ids"], sample["counts"], sample["threshold"], device)
    holders = torch.zeros(cfg["vocab"], dtype=torch.int64, device=device) if work else None
    for offset, b, o in _passes(cfg, seed, inp, device):
        counts = _minsum_counts(cq, b, o, cfg["max_count"])
        check.block(offset, counts, counts)
        if holders is not None:
            holders += torch.bincount(b[o == 0], minlength=cfg["vocab"])
    out = {"answer_faults": check.faults}
    if work:
        out["least_work"] = [least_work(cfg, query_vectors(cfg, inp, w.to(device)), holders)
                             for w in work]
    return out


def least_work(cfg: dict, cq: torch.Tensor, holders: torch.Tensor) -> dict:
    """The least operations and bytes one search's answer needs, whatever
    computes it: one integer operation for each (query, title, bucket) that
    is non-zero on both sides (a sparse intersection: holders[v] titles hold
    bucket v), one compare per object and query to select; the corpus's
    non-zeros read once at ceil(log2 vocab) + ceil(log2(max_count + 1)) bits
    each, the query vectors read once as given (int32 [Q, vocab]), the answer
    written once.  No intermediate (the [Q, N] counts, the CSR lists, the
    candidate buffers) counts, nor the dense int32 storage of the corpus."""
    q, v, k, n = cq.shape[0], cfg["vocab"], cfg["k"], cfg["n_objects"]
    nz = cq > 0
    triples = int((nz.double() @ holders.double()).sum())
    entry = (math.ceil(math.log2(v)) + math.ceil(math.log2(cfg["max_count"] + 1))) / 8
    corpus = int(holders.sum()) * entry
    match = {"ops": triples, "bytes": corpus + int(nz.sum()) * entry}
    search = {"ops": triples + q * n, "bytes": corpus + q * v * 4 + q * (2 * k + 1) * 4}
    return {"match": match, "search": search}


# ---------------------------------------------------------------------------
# The control
# ---------------------------------------------------------------------------

def control_answers(cfg: dict, seed: int, inp: dict, queries: torch.Tensor, device) -> dict:
    """The reference in the program's place with one guarantee broken: exact
    counts, but ties at the threshold taken in a random order (the paper's
    hash table fills in arrival order) instead of by id."""
    cq = query_vectors(cfg, inp, queries.to(device))
    top = TopkMerge(cfg["k"], tie_generator=generator(seed, "control-ties", device=device))
    for offset, b, o in _passes(cfg, seed, inp, device):
        top.block(offset, _minsum_counts(cq, b, o, cfg["max_count"]))
    ids, counts, threshold = top.result()
    return {"ids": ids.cpu(), "counts": counts.cpu(), "threshold": threshold.cpu(),
            "sims": None}
