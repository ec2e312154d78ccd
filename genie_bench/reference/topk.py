"""The comparison that decides `correct` for an exact count top-k, shared by
every deployment whose answer is one.

An answer to one query is `(ids [k], counts [k], threshold)`.  The guarantee
the configurations state: the k objects with the largest match counts,
ordered by (count desc, id asc), each with its exact count, and the
threshold equal to the k-th count (paper Theorem 3.1: AT - 1 = MC_k).

A reference gives, for each checked query and every object n, the interval
[lo, hi] of counts that a faithful run of the configuration can produce:
lo == hi where the arithmetic is exact; a float32 hash near a bucket edge
widens it (reference/e2lsh_eq.py).  An answer is then faulty at each
returned object whose count lies outside its interval, and at each object
it leaves out although it had to be in: lo above the threshold, or lo equal
to it with an id below the last id the answer returns at that count.
"""
from __future__ import annotations

import numpy as np
import torch


def malformed_rows(ids: np.ndarray, counts: np.ndarray, threshold: np.ndarray,
                   n_objects: int) -> int:
    """Answers that break the contract on their own, without a reference:
    an id out of range or repeated, counts not in (count desc, id asc)
    order, a threshold that is not the k-th count.  Arrays [B, k] / [B]."""
    bad = ((ids < 0) | (ids >= n_objects)).any(axis=1)
    desc = counts[:, :-1] >= counts[:, 1:]
    ties_by_id = (counts[:, :-1] != counts[:, 1:]) | (ids[:, :-1] < ids[:, 1:])
    bad |= ~(desc & ties_by_id).all(axis=1)
    bad |= threshold != counts[:, -1]
    ordered = np.sort(ids, axis=1)
    bad |= (ordered[:, 1:] == ordered[:, :-1]).any(axis=1)
    return int(bad.sum())


class TopkCheck:
    """Faults of S answers against a reference fed one block of objects at a
    time (`block`), in any order of blocks."""

    def __init__(self, ids, counts, threshold, device):
        self.ids = torch.as_tensor(ids).to(device=device, dtype=torch.int64)
        self.counts = torch.as_tensor(counts).to(device=device, dtype=torch.int32)
        self.t = torch.as_tensor(threshold).to(device=device, dtype=torch.int32)[:, None]
        at_t = self.counts == self.t
        # the largest id returned at the threshold: an object with a smaller
        # id and a count of at least the threshold had to come before it
        self.last_tie = torch.where(at_t, self.ids, -1).amax(dim=1, keepdim=True)
        self.faults = 0

    def block(self, offset: int, lo: torch.Tensor, hi: torch.Tensor) -> None:
        """Objects [offset, offset + R): lo, hi int [S, R]."""
        s, r = lo.shape
        local = self.ids - offset
        inside = (local >= 0) & (local < r)
        at = torch.where(inside, local, 0)
        got_lo = lo.gather(1, at).to(torch.int32)
        got_hi = hi.gather(1, at).to(torch.int32)
        self.faults += int((inside & ((self.counts < got_lo) | (self.counts > got_hi))).sum())
        # column r collects the ids outside this block
        returned = torch.zeros((s, r + 1), dtype=torch.bool, device=lo.device)
        returned.scatter_(1, torch.where(inside, local, r), True)
        gid = offset + torch.arange(r, device=lo.device)
        lo = lo.to(torch.int32)
        missed = ((lo > self.t) | ((lo == self.t) & (gid[None, :] < self.last_tie)))
        self.faults += int((missed & ~returned[:, :r]).sum())


class TopkMerge:
    """The exact top-k of S queries built one block of objects at a time,
    ordered by (count desc, id asc), or with ties at random when
    `tie_generator` is given (a control: c-PQ's hash table filled in
    arrival order, as the paper's breaks ties)."""

    def __init__(self, k: int, tie_generator: torch.Generator | None = None):
        self.k = k
        self.gen = tie_generator
        self.keys = None
        self.ids = None

    def block(self, offset: int, counts: torch.Tensor) -> None:
        s, r = counts.shape
        gid = offset + torch.arange(r, device=counts.device, dtype=torch.int64)
        if self.gen is None:
            low = ((1 << 32) - 1 - gid)[None, :].expand(s, r)
        else:
            low = torch.randint(0, 1 << 32, (s, r), generator=self.gen,
                                device=counts.device, dtype=torch.int64)
        keys = (counts.to(torch.int64) << 32) | low
        ids = gid[None, :].expand(s, r)
        if self.keys is not None:
            keys = torch.cat([self.keys, keys], dim=1)
            ids = torch.cat([self.ids, ids], dim=1)
        top = keys.topk(min(self.k, keys.shape[1]), dim=1)
        self.keys = top.values
        self.ids = ids.gather(1, top.indices)

    def result(self):
        """(ids int64 [S, k], counts int32 [S, k], threshold int32 [S])."""
        counts = (self.keys >> 32).to(torch.int32)
        return self.ids, counts, counts[:, -1]
