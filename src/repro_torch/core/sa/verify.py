"""Verification for SA sequence search (paper Algorithm 2 + Theorem 5.2).

The GPU of the paper verifies candidates serially with an early break (Alg 2
lines 5-6); here the whole K-candidate list is verified at once with a
Wagner-Fischer DP batched over the candidates -- one DP row [K, La + 1] per
step over the candidates' characters -- and then the same filters and
Theorem 5.2 certificate apply.  Results are identical: the early break only
skips work, never changes the answer.

The row update of the DP is vectorised with the min-plus prefix trick: with
t[i] = min(prev[i-1] + sub_i, prev[i] + 1), the insertion recurrence
new[i] = min(t[i], new[i-1] + 1) solves to new[i] = i + cummin_{i'<=i}(t[i'] - i'),
turning the sequential dependency into a `torch.cummin` (the reference's
`lax.cummin`).

Ported from `repro/core/sa/verify.py`, which scans one candidate at a time
under `vmap`; same results on the same inputs.
"""
from __future__ import annotations

import torch


def _as_int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def edit_distance_one_to_many(query: torch.Tensor, q_len, cands: torch.Tensor,
                              c_lens: torch.Tensor) -> torch.Tensor:
    """ed(query[:q_len], cands[k, :c_lens[k]]) for K padded candidates:
    query int [Lq], cands int [K, Lc], c_lens int [K] -> int32 [K].

    Row j of the DP is D[j, :] for the first j characters of every candidate
    at once; each candidate's distance is read from its own row c_lens[k]
    (lengths past Lc read row Lc, as the reference's clamped gather does)."""
    la_max = query.shape[0]
    la = min(max(_as_int(q_len), 0), la_max)
    k, lc = cands.shape
    device = cands.device
    idx = torch.arange(la_max + 1, dtype=torch.int32, device=device)
    prev = idx.expand(k, la_max + 1)                        # D[0, i] = i
    lens = c_lens.to(device=device, dtype=torch.int64).clamp(0, lc)
    out = torch.full((k,), la, dtype=torch.int32, device=device)   # D[0, la]
    a = query.to(device)[None, :]
    for j in range(lc):
        sub = (a != cands[:, j:j + 1]).to(torch.int32)                 # [K, La]
        t = torch.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)         # i = 1..La
        lead = prev[:, :1] + 1                                          # new[0]
        # new[i] = i + cummin_{i' <= i}(t[i'] - i'), new[0] = lead
        prev = torch.cummin(torch.cat([lead, t], dim=1) - idx, dim=1).values + idx
        out = torch.where(lens == j + 1, prev[:, la], out)
    return out


def edit_distance(a: torch.Tensor, la, b: torch.Tensor, lb) -> torch.Tensor:
    """Edit distance between padded int sequences a [La] and b [Lb] (int32
    scalar).  Padding must be a value that never equals a real symbol."""
    lens = torch.tensor([_as_int(lb)], dtype=torch.int64, device=b.device)
    return edit_distance_one_to_many(a, la, b[None, :], lens)[0]


def verify_topk(
    query: torch.Tensor,
    q_len,
    cand_seqs: torch.Tensor,
    cand_lens: torch.Tensor,
    cand_counts: torch.Tensor,
    k: int,
    n: int,
) -> dict:
    """Batched Algorithm 2: exact edit distances for the K GENIE candidates,
    the best-k by edit distance, and Theorem 5.2's exactness certificate.

    cand_counts must be sorted descending (GENIE returns them so); invalid
    candidate slots are marked by cand_lens == 0.  Equal edit distances rank
    the lower candidate slot first (a stable sort), as the reference's
    `lax.top_k` on the negated distances does.
    """
    kk = cand_seqs.shape[0]
    valid = cand_lens > 0
    big = 10**6
    eds = torch.where(valid, edit_distance_one_to_many(query, q_len, cand_seqs, cand_lens),
                      big).to(torch.int32)
    best_eds, order = torch.sort(eds, stable=True)
    best_eds, order = best_eds[:min(k, kk)], order[:min(k, kk)].to(torch.int32)
    # Theorem 5.2: exact iff c_K < |Q| - n + 1 - tau_k' * n
    tau_k = best_eds[-1]
    c_k = cand_counts[-1]
    bound = _as_int(q_len) - n + 1 - tau_k * n
    certified = c_k < bound
    return dict(order=order, edit_distances=best_eds, certified_exact=certified, tau_k=tau_k)
