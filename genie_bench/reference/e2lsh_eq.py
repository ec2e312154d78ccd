"""E2LSH -> EQ (the sift-e2lsh deployment): inputs, plain reference, least
work.  Plain PyTorch; nothing of the program under test.

Inputs from `--seed`: the E2LSH functions (a ~ N(0, 1) [m, d], b ~ U[0, w),
rehash seeds in [0, 2^32)), handed to the program as they are; the corpus as
`segments` adds of N(0, I) points; N(0, I) query points, block by block.

The hash of the configuration (paper Eqn 10, section IV-A2):
sig_i(x) = fmix32(floor((a_i . x + b_i) / w) ^ seed_i) mod n_buckets, the
projection in float32.  A float32 sum is exact to within
gamma_n * sum |terms| (n roundings, any order, FMA or not), so the reference
works each projection out in float64 with that bound: an entry whose float64
value lies within the bound of an integer may take either floor in a
faithful float32 run, and both buckets are admitted there.  A count is then
an interval [lo, hi] (reference/topk.py).  TF32 (10-bit inputs) moves
projections some ten times further than the bound: the control.
"""
from __future__ import annotations

import math

import torch

from genie_bench.harness.seeds import generator
from genie_bench.reference.topk import TopkCheck, TopkMerge

_U32 = 0xFFFFFFFF
_C1, _C2 = 0x85EBCA6B, 0xC2B2AE35
# elements of one block of one-hot rows [rows, m * n_buckets]
_BLOCK = 1 << 30


def gamma(n: int) -> float:
    """n * u / (1 - n * u) for float32's unit roundoff u = 2^-24."""
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 in int64 without overflow, for x in [0, 2^32)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def rehash(raw: torch.Tensor, seeds: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Bucket ids int32 of integer raw hashes [..., m] (uint32 wraparound)."""
    return (fmix32((raw.to(torch.int64) & _U32) ^ seeds) % n_buckets).to(torch.int32)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def inputs(cfg: dict, seed: int, device) -> dict:
    """The E2LSH functions: float32 a [m, d], b [m]; int64 seeds [m]."""
    g = generator(seed, "e2lsh", device=device)
    m, d, w = cfg["m"], cfg["dim"], float(cfg["w"])
    a = torch.randn((m, d), generator=g, device=device, dtype=torch.float32)
    b = torch.rand((m,), generator=g, device=device, dtype=torch.float32) * w
    seeds = torch.randint(0, 1 << 32, (m,), generator=g, device=device, dtype=torch.int64)
    return {"a": a, "b": b, "seeds": seeds}


def rows_per_add(cfg: dict) -> int:
    n, s = cfg["n_objects"], cfg["segments"]
    if n % s:
        raise ValueError(f"{s} adds do not divide {n} objects")
    return n // s


def corpus_chunk(cfg: dict, seed: int, inp: dict, s: int, device) -> torch.Tensor:
    """The points of add `s`, float32 [rows, d]."""
    g = generator(seed, "corpus", s, device=device)
    return torch.randn((rows_per_add(cfg), cfg["dim"]), generator=g, device=device)


def queries(cfg: dict, seed: int, inp: dict, blocks, rows: int, device) -> torch.Tensor:
    """`rows` query points of each block of the query stream, each block
    from a stream of the seed of its own: float32 [len(blocks) * rows, d]."""
    return torch.cat([torch.randn((rows, cfg["dim"]), device=device,
                                  generator=generator(seed, "queries", b, device=device))
                      for b in blocks])


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def signatures(cfg: dict, inp: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sig, alt) int32 [n, m]: the float64 hash, and where a float32 run may
    take the other floor, that floor's bucket (elsewhere alt == sig)."""
    a = inp["a"].double()
    b = inp["b"].double()
    w = float(cfg["w"])
    x = x.double()
    v = (x @ a.T + b) / w
    bound = (x.abs() @ a.abs().T + b.abs()) * (gamma(x.shape[1] + 3) / w)
    f = torch.floor(v)
    r = torch.round(v)
    near = (v - r).abs() <= bound
    sig = rehash(f, inp["seeds"], cfg["n_buckets"])
    other = rehash(torch.where(f == r, r - 1, r), inp["seeds"], cfg["n_buckets"])
    return sig, torch.where(near, other, sig)


def signatures_tf32(cfg: dict, inp: dict, x: torch.Tensor) -> torch.Tensor:
    """The control's hash: the same float32 arithmetic with a and x rounded
    to TF32 (10 stored mantissa bits) first, as a TF32 matmul takes them."""
    proj = round_tf32(x.float()) @ round_tf32(inp["a"]).T
    raw = torch.floor((proj + inp["b"]) / float(cfg["w"]))
    return rehash(raw, inp["seeds"], cfg["n_buckets"])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest float32 with 10 mantissa bits (ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def _eq_counts(qs: torch.Tensor, ns: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """counts int32 [Q, R]: positions where two signatures agree, as the
    product of their one-hot encodings [*, m * n_buckets].  Exact: the
    one-hots are 0 and 1, and every partial sum is a whole number of at
    most m < 2048, which float16 holds exactly."""
    dtype = torch.float16 if qs.is_cuda else torch.float32
    m = qs.shape[1]
    cols = torch.arange(m, device=qs.device, dtype=torch.int64) * n_buckets

    def hot(sig):
        out = torch.zeros((sig.shape[0], m * n_buckets), dtype=dtype, device=sig.device)
        return out.scatter_(1, sig.to(torch.int64) + cols, 1.0)

    hq = hot(qs)
    out = torch.empty((qs.shape[0], ns.shape[0]), dtype=torch.int32, device=qs.device)
    step = max(1, _BLOCK // (m * n_buckets))
    for j in range(0, ns.shape[0], step):
        out[:, j:j + step] = (hq @ hot(ns[j:j + step]).T).to(torch.int32)
    return out


def _count_bounds(q: tuple, n: tuple, n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 [Q, R]: positions equal in every faithful run, and in
    some faithful run.  lo is the plain count less the agreements at
    positions where either side is near a bucket edge; hi adds back the
    positions there whose admissible buckets meet.  Near positions are
    few (a few in ten thousand), so both corrections are sparse."""
    (qa, qb), (na, nb) = q, n
    lo = _eq_counts(qa, na, n_buckets)
    extra = torch.zeros_like(lo)
    # positions near an edge on the corpus side (and perhaps on both)
    rn, i = (na != nb).nonzero(as_tuple=True)
    if rn.numel():
        a, b = qa[:, i], qb[:, i]
        same = a == na[rn, i]
        meet = same | (a == nb[rn, i]) | (b == na[rn, i]) | (b == nb[rn, i])
        lo.index_add_(1, rn, -same.to(torch.int32))
        extra.index_add_(1, rn, meet.to(torch.int32))
    # positions near an edge on the query side alone
    rq, i = (qa != qb).nonzero(as_tuple=True)
    if rq.numel():
        a = na[:, i]
        sure = a == nb[:, i]
        same = (a == qa[rq, i]) & sure
        meet = ((a == qa[rq, i]) | (a == qb[rq, i])) & sure
        lo.index_add_(0, rq, -same.T.to(torch.int32))
        extra.index_add_(0, rq, meet.T.to(torch.int32))
    return lo, lo + extra


def evaluate(cfg: dict, seed: int, inp: dict, queries: torch.Tensor, sample: dict,
             work: list | None, device) -> dict:
    """One pass over the corpus.  `queries`: the query points of the checked
    answers; `sample`: those answers (`ids`, `counts`, `threshold`,
    `sims`).  `work`: the query points of each traced search, or None.
    Returns the answers' faults and, with `work`, each search's least work
    (`least_work`)."""
    q = signatures(cfg, inp, queries.to(device))
    check = TopkCheck(sample["ids"], sample["counts"], sample["threshold"], device)
    m, n_buckets = cfg["m"], cfg["n_buckets"]
    hist = torch.zeros(m * n_buckets, dtype=torch.int64, device=device) if work else None
    col = torch.arange(m, device=device) * n_buckets
    per = rows_per_add(cfg)
    for s in range(cfg["segments"]):
        n = signatures(cfg, inp, corpus_chunk(cfg, seed, inp, s, device))
        check.block(s * per, *_count_bounds(q, n, n_buckets))
        if hist is not None:
            hist += torch.bincount((n[0].to(torch.int64) + col).flatten(),
                                   minlength=m * n_buckets)
        del n
    # the MLE the service returns beside the counts: c / m (paper Eqn 7)
    sims = torch.as_tensor(sample["sims"], dtype=torch.float64)
    faults = check.faults + int((sims != torch.as_tensor(sample["counts"]).double() / m).sum())
    out = {"answer_faults": faults}
    if work:
        out["least_work"] = [least_work(cfg, inp, w.to(device), hist.view(m, n_buckets))
                             for w in work]
    return out


def least_work(cfg: dict, inp: dict, queries: torch.Tensor, hist: torch.Tensor) -> dict:
    """The least operations and bytes one search's answer needs, whatever
    computes it: one integer add per collision (sum over queries and hash
    functions of the corpus rows in the query's bucket), one compare per
    object and query to select, the queries' float32 projections (2 d m a
    query); the corpus signatures read once at ceil(log2 n_buckets) bits,
    the query points and the E2LSH functions read once, the answer (ids,
    counts, threshold, float64 estimates) written once.  No intermediate
    (the [Q, N] counts, candidate buffers) counts."""
    q, d, m = queries.shape[0], cfg["dim"], cfg["m"]
    n, k = cfg["n_objects"], cfg["k"]
    sig = signatures(cfg, inp, queries)[0].to(torch.int64)
    collisions = int(hist.gather(1, sig.T).sum())
    sig_bytes = m * math.ceil(math.log2(cfg["n_buckets"])) / 8
    match = {"ops": collisions, "bytes": (n + q) * sig_bytes}
    search = {"ops": collisions + q * n + 2 * q * d * m,
              "bytes": n * sig_bytes + (q * d + m * d + 2 * m) * 4 + q * (2 * k + 1) * 4
              + q * k * 8}
    return {"match": match, "search": search}


# ---------------------------------------------------------------------------
# The control
# ---------------------------------------------------------------------------

def control_answers(cfg: dict, seed: int, inp: dict, queries: torch.Tensor, device) -> dict:
    """The reference in the program's place, in TF32: its exact top-k over
    TF32 signatures, for the query points `queries`."""
    q = signatures_tf32(cfg, inp, queries.to(device))
    top = TopkMerge(cfg["k"])
    per = rows_per_add(cfg)
    for s in range(cfg["segments"]):
        top.block(s * per, _eq_counts(q, signatures_tf32(
            cfg, inp, corpus_chunk(cfg, seed, inp, s, device)), cfg["n_buckets"]))
    ids, counts, threshold = top.result()
    return {"ids": ids.cpu(), "counts": counts.cpu(), "threshold": threshold.cpu(),
            "sims": counts.cpu().double() / cfg["m"]}
