"""Postings-list (CSR) inverted-index engine + load balancing (paper III-B).

The counterpart of `repro/core/postings.py`.  An explicit inverted index with
one postings list per keyword, kept for (a) the CPU-Idx baseline of the
paper's experiments and (b) the load-balance study (Fig 4 / Fig 12): long
postings lists are split into fixed-size sub-lists ("one block takes at most
two 4K sub-lists").  An unsplit engine pads every scanned list to the global
maximum length; a split engine works on uniform tiles.

`build`, `scan_counts_numpy` (CPU-Idx) and `split_tiles` are host numpy, line
for line the reference's.  `scan_counts_tiled` takes tensors and runs on
their device: a plain PyTorch scatter-add, as the reference's is an XLA
scatter-add (no Pallas kernel).  The hot path is the dense engine of
core/match.py and its kernels; this module is held against it (same match
counts).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.types import IndexStats

# Transient device bytes one query chunk of `scan_counts_tiled` may take:
# the chunk's gathered tile slots (SLOT_BYTES each) plus its count rows
# (ROW_BYTES per object).  A query whose own slots exceed it runs alone.
DEFAULT_SCAN_BYTES = 1 << 30
# a gathered slot: its int32 id, the int64 flat index and the int64 select
# that sends pads to the dump bin, and the pad mask (21 bytes), rounded up
SLOT_BYTES = 32
# a count row entry: bincount's int64 bin and the int32 copy into the result
ROW_BYTES = 12


@dataclasses.dataclass
class PostingsIndex:
    """CSR inverted index over keyword ids in [0, n_keywords)."""

    n_objects: int
    n_keywords: int
    indptr: np.ndarray      # [n_keywords + 1]
    indices: np.ndarray     # [total_postings]  object ids, list-major
    stats: IndexStats

    @classmethod
    def build(cls, keywords: np.ndarray, n_keywords: int) -> "PostingsIndex":
        """keywords: int [N, m] -- m keyword ids per object (LSH signatures
        offset by function index, n-gram bucket ids, (attr, value) codes...)."""
        # perf_counter, not time(): a wall-clock (NTP) step must never record
        # a negative build duration
        t0 = time.perf_counter()
        keywords = np.asarray(keywords)
        n, m = keywords.shape
        flat = keywords.astype(np.int64).ravel()
        obj = np.repeat(np.arange(n, dtype=np.int32), m)
        order = np.argsort(flat, kind="stable")
        flat_sorted = flat[order]
        indices = obj[order]
        counts = np.bincount(flat_sorted, minlength=n_keywords)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        stats = IndexStats(
            n_objects=n,
            n_lists=int(np.sum(counts > 0)),
            total_postings=int(flat.size),
            max_list_len=int(counts.max()) if counts.size else 0,
            bytes_device=int(indices.nbytes + indptr.nbytes),
            build_seconds=time.perf_counter() - t0,
        )
        return cls(n_objects=n, n_keywords=n_keywords, indptr=indptr, indices=indices, stats=stats)

    # ------------------------------------------------------------------
    # CPU-Idx baseline (paper competitor): pure numpy postings scan.
    # ------------------------------------------------------------------
    def scan_counts_numpy(self, query_keywords: np.ndarray) -> np.ndarray:
        """counts [Q, N]: scan the matched postings lists per query (a list
        named twice by one query is scanned twice)."""
        query_keywords = np.asarray(query_keywords)
        q, m = query_keywords.shape
        out = np.zeros((q, self.n_objects), dtype=np.int32)
        for qi in range(q):
            for kw in query_keywords[qi]:
                s, e = self.indptr[kw], self.indptr[kw + 1]
                np.add.at(out[qi], self.indices[s:e], 1)
        return out

    # ------------------------------------------------------------------
    # Tiled device engine with the paper's sub-list splitting.
    # ------------------------------------------------------------------
    def split_tiles(self, limit: int = 4096) -> tuple[np.ndarray, np.ndarray]:
        """Split postings lists into <=limit-sized sub-lists (paper Fig 4).

        Returns (tiles [T, limit] int32, object ids padded with -1;
                 tile_keyword [T] int32, owning keyword of each tile).
        When limit >= max_list_len this degenerates to one padded tile per
        list -- the "no load balance" configuration, whose padding waste is
        the work an unsplit engine spends on short lists.
        """
        tiles, tile_kw = [], []
        for kw in range(self.n_keywords):
            s, e = int(self.indptr[kw]), int(self.indptr[kw + 1])
            if s == e:
                continue
            seg = self.indices[s:e]
            for off in range(0, len(seg), limit):
                sub = seg[off : off + limit]
                pad = np.full(limit, -1, dtype=np.int32)
                pad[: len(sub)] = sub
                tiles.append(pad)
                tile_kw.append(kw)
        if not tiles:
            return np.zeros((0, limit), np.int32), np.zeros((0,), np.int32)
        return np.stack(tiles), np.asarray(tile_kw, dtype=np.int32)

    def scan_counts_tiled(
        self, tiles: torch.Tensor, tile_kw: torch.Tensor, query_keywords: torch.Tensor,
        *, max_transient_bytes: int = DEFAULT_SCAN_BYTES,
    ) -> torch.Tensor:
        """Tiled postings scan: counts [Q, N] int32 by scatter-add over the
        active tiles, on the tensors' device.

        A tile is active for a query iff its keyword is among the query's
        keywords (once, however often the query names it); every active tile
        contributes +1 for each object id in [0, N) it holds (-1 pads and ids
        outside [0, N) add nothing, as the reference's `mode="drop"`).

        The reference vmaps one query at a time over all T x L tile slots, so
        a batched form holds [Q, T, L] masks: tens of GB at a SIFT segment.
        Here only the active tiles are gathered, and the queries run in
        chunks whose transient -- SLOT_BYTES per gathered slot plus ROW_BYTES
        per count entry -- stays under `max_transient_bytes` (default 1 GiB;
        a query over it alone runs alone), besides [Q, n_keywords + 1] and
        [Q, T] bool masks and the [Q, N] int32 result.
        """
        dev = tiles.device
        if tile_kw.device != dev or query_keywords.device != dev:
            raise ValueError(
                f"scan_counts_tiled: tiles on {dev}, tile_kw on {tile_kw.device}, "
                f"queries on {query_keywords.device}; they must share a device")
        n = self.n_objects
        q = int(query_keywords.shape[0])
        n_tiles, limit = tiles.shape
        out = torch.zeros((q, n), dtype=torch.int32, device=dev)
        if q == 0 or n == 0 or n_tiles == 0:
            return out
        # the query's keyword set as a mask; keywords outside [0, n_keywords)
        # name no list, so they go to a dump column
        qkw = query_keywords.to(torch.int64)
        qkw = torch.where((qkw >= 0) & (qkw < self.n_keywords), qkw, self.n_keywords)
        named = torch.zeros((q, self.n_keywords + 1), dtype=torch.bool, device=dev)
        named.scatter_(1, qkw, True)
        active = named[:, tile_kw.to(torch.int64)]                    # [Q, T]
        del named
        slots = (active.sum(dim=1) * limit).cpu().numpy()
        cost = slots * SLOT_BYTES + n * ROW_BYTES
        start = 0
        while start < q:
            stop, used = start + 1, int(cost[start])
            while stop < q and used + int(cost[stop]) <= max_transient_bytes:
                used += int(cost[stop])
                stop += 1
            out[start:stop] = self._scan_chunk(tiles, active[start:stop])
            start = stop
        return out

    def _scan_chunk(self, tiles: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """Counts [c, N] int32 of `c` queries from their active-tile mask."""
        n = self.n_objects
        c = int(active.shape[0])
        qi, ti = torch.nonzero(active, as_tuple=True)
        rows = tiles.index_select(0, ti)                              # [P, L]
        flat = rows.to(torch.int64) + (qi * n)[:, None]
        flat = torch.where((rows >= 0) & (rows < n), flat, c * n)     # pads: dump bin
        del rows
        counts = torch.bincount(flat.view(-1), minlength=c * n + 1)
        return counts[: c * n].view(c, n).to(torch.int32)
