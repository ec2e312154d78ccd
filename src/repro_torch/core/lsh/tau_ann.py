"""tau-ANN theory (paper section IV-B).

Definition 4.1 (tau-ANN): return p with |sim(p,q) - sim(p*,q)| <= tau w.h.p.

Theorem 4.1 gives the conservative bound  m = ceil(2 ln(3/delta) / eps^2)
hash functions for |MC/m - sim| < eps + 1/D  w.p. >= 1 - delta.

Eqn 9 gives the practical (data-independent) bound: for true similarity s the
count c ~ Binomial(m, s), so

    Pr[|c/m - s| <= eps] = sum_{c=floor((s-eps)m)}^{ceil((s+eps)m)} C(m,c) s^c (1-s)^(m-c)

and the required m for a given (eps, delta) is the max over s of the minimal m
meeting the constraint.  The paper (Fig 8) reports m = 237 at eps = delta = 0.06
with the worst case at s = 0.5; `required_m` reproduces this.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
from scipy import stats


def m_theorem41(eps: float, delta: float) -> int:
    """Conservative bound of Theorem 4.1: m = ceil(2 ln(3/delta) / eps^2)."""
    return int(math.ceil(2.0 * math.log(3.0 / delta) / (eps * eps)))


def prob_within(m: int, s: float, eps: float) -> float:
    """Pr[|c/m - s| <= eps] with c ~ Binomial(m, s)  (paper Eqn 8/9).

    Note: Eqn 9 prints the summation limits as floor((s-eps)m)..ceil((s+eps)m),
    but the event |c/m - s| <= eps corresponds to ceil((s-eps)m) <= c <=
    floor((s+eps)m); the printed convention admits c outside the eps-window and
    makes m=1 trivially "sufficient".  We use the exact event (and reproduce the
    paper's m = 237 at eps = delta = 0.06, worst case s = 0.5 -- Fig 8).
    """
    lo = int(math.ceil((s - eps) * m))
    hi = int(math.floor((s + eps) * m))
    lo = max(lo, 0)
    hi = min(hi, m)
    if lo > hi:
        return 0.0
    # sum_{c=lo}^{hi} Binom(m, s).pmf(c) = cdf(hi) - cdf(lo - 1)
    b = stats.binom(m, s)
    return float(b.cdf(hi) - (b.cdf(lo - 1) if lo > 0 else 0.0))


def min_m_for_similarity(s: float, eps: float, delta: float, m_max: int = 4096) -> int:
    """Minimal m such that Pr[|c/m - s| <= eps] >= 1 - delta (binary search is
    invalid -- the binomial tail is not monotone in m due to the floor/ceil
    window -- so scan linearly)."""
    for m in range(1, m_max + 1):
        if prob_within(m, s, eps) >= 1.0 - delta:
            return m
    return m_max


@lru_cache(maxsize=None)
def required_m(eps: float, delta: float, s_grid: int = 101, m_max: int = 4096) -> int:
    """Data-independent practical m: max over similarity values of min_m (Fig 8)."""
    best = 0
    for i in range(1, s_grid - 1):
        s = i / (s_grid - 1)
        best = max(best, min_m_for_similarity(s, eps, delta, m_max))
    return best


def fig8_curve(eps: float = 0.06, delta: float = 0.06, s_grid: int = 101, m_max: int = 4096):
    """(s, min m) pairs reproducing paper Fig 8."""
    ss = [i / (s_grid - 1) for i in range(1, s_grid - 1)]
    return np.array(ss), np.array([min_m_for_similarity(s, eps, delta, m_max) for s in ss])


def mle_similarity(count, m: int):
    """MLE estimate s_hat = c/m (paper Eqn 7)."""
    return np.asarray(count, dtype=np.float64) / float(m)
