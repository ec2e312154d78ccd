"""Match-count reference semantics (paper Definition 2.1), dense formulation.

Each function computes counts[q, n] = MC(Q_q, O_n) for a query batch against
all objects.  These plain PyTorch implementations are the semantics oracles
for the CUDA kernels in repro_torch.kernels and the path a CPU tensor takes.
They are not called directly by the index machinery: engine dispatch goes
through the MatchModel registry (core/engines.py).  Every engine of the JAX
package's registry has its oracle here.

Memory note: counts are bounded by max_count (m hash functions / #attributes /
#grams) -- the paper's Bitmap-Counter observation (section III-C) -- so an int8
output is lossless whenever max_count <= 127; `as_count_dtype` applies it.
"""
from __future__ import annotations

import torch


def as_count_dtype(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """Bitmap-Counter bit-bounding: store counts in the narrowest safe dtype."""
    if max_count <= 127:
        return counts.to(torch.int8)
    if max_count <= 32767:
        return counts.to(torch.int16)
    return counts.to(torch.int32)


def match_eq(data_sigs: torch.Tensor, query_sigs: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """EQ engine: counts[q, n] = sum_i (data_sigs[n, i] == query_sigs[q, i]).

    data_sigs:  int [N, m], query_sigs: int [Q, m] -> int32 [Q, N].
    A loop over `chunk` columns at a time keeps the live temp at
    [Q, N, chunk] regardless of m.
    """
    q, m = query_sigs.shape
    n = data_sigs.shape[0]
    acc = torch.zeros((q, n), dtype=torch.int32, device=data_sigs.device)
    for s in range(0, m, chunk):
        hit = query_sigs[:, None, s:s + chunk] == data_sigs[None, :, s:s + chunk]
        acc += hit.sum(dim=-1, dtype=torch.int32)
    return acc


def match_range(data_vals: torch.Tensor, q_lo: torch.Tensor, q_hi: torch.Tensor,
                chunk: int = 8) -> torch.Tensor:
    """RANGE engine: counts[q, n] = sum_d (q_lo[q,d] <= data_vals[n,d] <= q_hi[q,d]).

    Implements the relational-table match count (paper Example 2.1 / section
    V-C) directly on discretized attribute values -- the inverted index over
    (attribute, value) keywords is semantically this predicate count.
    data_vals int [N, d], q_lo / q_hi int [Q, d] -> int32 [Q, N]; an empty
    range (lo > hi) counts nothing.  The loop over `chunk` attributes keeps
    the live temp at [Q, N, chunk].
    """
    x = data_vals.to(torch.int32)
    lo, hi = q_lo.to(torch.int32), q_hi.to(torch.int32)
    q, d = lo.shape
    acc = torch.zeros((q, x.shape[0]), dtype=torch.int32, device=x.device)
    for s in range(0, d, chunk):
        xs = x[None, :, s:s + chunk]
        hit = (xs >= lo[:, None, s:s + chunk]) & (xs <= hi[:, None, s:s + chunk])
        acc += hit.sum(dim=-1, dtype=torch.int32)
    return acc


def match_minsum(data_cnt: torch.Tensor, query_cnt: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """MINSUM engine: counts[q, n] = sum_v min(data_cnt[n,v], query_cnt[q,v]).

    Exactly Lemma 5.1's ordered-n-gram match count when the count vectors are
    per-gram-type multiplicities (bucketised count vectors give an upper
    bound; see sa/ngram.py).  data_cnt int [N, V], query_cnt int [Q, V] ->
    int32 [Q, N]; the temp stays [Q, N, chunk].
    """
    d = data_cnt.to(torch.int32)
    s = query_cnt.to(torch.int32)
    q, v = s.shape
    acc = torch.zeros((q, d.shape[0]), dtype=torch.int32, device=d.device)
    for start in range(0, v, chunk):
        low = torch.minimum(s[:, None, start:start + chunk], d[None, :, start:start + chunk])
        acc += low.sum(dim=-1, dtype=torch.int32)
        del low
    return acc


# columns of V per float64 product in match_ip: the float64 copy of the data
# stays [N, 1024]
_IP_CHUNK = 1024


def match_ip(data_bin: torch.Tensor, query_bin: torch.Tensor) -> torch.Tensor:
    """IP engine: counts = query_bin @ data_bin^T (binary word vectors).

    The short-document model of section V-B: MC == inner product of binary
    word vectors.  [N, V] x [Q, V] -> int32 [Q, N], exact at any V: the
    products and their sums are taken in float64 (exact to 2**53; PyTorch has
    no integer matmul on CUDA), _IP_CHUNK columns of V at a time, then rounded
    as the reference rounds its float32 sum (which is exact only below 2**24).
    """
    q64 = query_bin.to(torch.float64)
    acc = torch.zeros((q64.shape[0], data_bin.shape[0]), dtype=torch.float64,
                      device=data_bin.device)
    for start in range(0, q64.shape[1], _IP_CHUNK):
        cols = slice(start, start + _IP_CHUNK)
        acc += q64[:, cols] @ data_bin[:, cols].to(torch.float64).T
    return torch.round(acc).to(torch.int32)


def match_tanimoto(data_sigs: torch.Tensor, query_sigs: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """TANIMOTO engine: counts[q, n] = sum_i (data_sigs[n, i] == query_sigs[q, i])
    over *minhash* signatures.

    Pr[h(S) = h(T)] = J(S, T) for minhash (core/lsh/minhash.py), so the
    collision count c is Binomial(m, J) and J_hat = c/m is the Jaccard MLE --
    the sketch-collision counting at the heart of FLASH (Wang et al.,
    1709.01190).  The arithmetic is the EQ compare; the engines differ in data
    semantics (minhash sketches of sets vs. generic LSH signatures), count
    interpretation, and kernel (kernels/tanimoto_count.py).
    """
    return match_eq(data_sigs, query_sigs, chunk=chunk)


def tanimoto_exact(data_cnt: torch.Tensor, query_cnt: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """Exact (multiset) Tanimoto  sum_v min / sum_v max  -> float32 [Q, N].

    The validation oracle for the TANIMOTO engine: on multiset count vectors
    the engine's minhash-collision estimate J_hat = c/m converges to this
    ratio (binary vectors give exactly set Jaccard).  Not a match-count --
    GENIE counts stay integral; this is the similarity the counts estimate.
    """
    d = data_cnt.to(torch.int32)
    s = query_cnt.to(torch.int32)
    mins = match_minsum(d, s, chunk=chunk)
    # min(a,b) + max(a,b) == a + b, so sum-max follows from row sums -- no
    # second O(Q*N*V) pass
    maxs = (d.sum(dim=-1, dtype=torch.int32)[None, :]
            + s.sum(dim=-1, dtype=torch.int32)[:, None] - mins)
    return mins.to(torch.float32) / torch.clamp(maxs, min=1).to(torch.float32)


def match_cosine(data_sgn: torch.Tensor, query_sgn: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """COSINE engine: counts[q, n] = #sign agreements = (V + <s_q, s_n>) // 2.

    data_sgn / query_sgn are sign-quantized vectors in {-1, +1} ([N, V] /
    [Q, V]) -> int32 [Q, N]; the agreement count of simhash bits equals the
    shifted +-1 inner product (kernels/cosine_count.py computes it on the
    card).  V + dot is even for genuine +-1 rows, so the halving is exact;
    zero pad rows floor to V // 2.  Products of int8 values are taken in
    int16 (exact for any int8 pair), so the temp stays [Q, N, chunk] int16.
    """
    v = int(data_sgn.shape[1])
    q, n = query_sgn.shape[0], data_sgn.shape[0]
    d = data_sgn.to(torch.int16)
    s = query_sgn.to(torch.int16)
    dot = torch.zeros((q, n), dtype=torch.int32, device=data_sgn.device)
    for start in range(0, v, chunk):
        prod = s[:, None, start:start + chunk] * d[None, :, start:start + chunk]
        dot += prod.sum(dim=-1, dtype=torch.int32)
        del prod
    return torch.div(v + dot, 2, rounding_mode="floor")
