"""The program under test for a MINSUM deployment: `SegmentedIndex(Engine.
MINSUM)` of `repro_torch`, WIDE count vectors, c-PQ, no autotune.  Its input
is count vectors, which the benchmark builds from the titles on the device
as `ngram.count_vectors` would (one scatter-add of the grams' buckets, then
the clip), so a search runs plan -> MINSUM conversion and count ->
histogram -> c-PQ gate, compaction and final order -> merge."""
from __future__ import annotations

import torch


def count_vectors(cfg: dict, inp: dict, titles: torch.Tensor) -> torch.Tensor:
    """int32 [rows, vocab]: each bucket's multiplicity of 3-grams, clipped."""
    t = titles.to(torch.int64)
    a, n = len(cfg["alphabet"]), cfg["gram"]
    codes = sum(t[:, j:t.shape[1] - n + 1 + j] * a ** (n - 1 - j) for j in range(n))
    out = torch.zeros((t.shape[0], cfg["vocab"]), dtype=torch.int32, device=t.device)
    out.scatter_add_(1, inp["table"][codes], torch.ones_like(codes, dtype=torch.int32))
    return out.clamp_(max=cfg["max_count"])


class System:
    def __init__(self, cfg: dict, seed: int, ref, inp: dict, device):
        from repro_torch.core import Engine, SegmentedIndex, TopKMethod

        self.cfg, self.inp = cfg, inp
        self.k = cfg["k"]
        self.method = TopKMethod.CPQ
        self.index = SegmentedIndex(Engine.MINSUM, max_count=cfg["max_count"], device=device)
        for s in range(cfg["segments"]):
            self.index.add(count_vectors(cfg, inp, ref.corpus_chunk(cfg, seed, inp, s, device)))

    def prepare(self, raw_pool: torch.Tensor) -> torch.Tensor:
        """The queries as the program takes them: count vectors."""
        return count_vectors(self.cfg, self.inp, raw_pool)

    def backend(self):
        """What the program's serving front-end takes as a tenant."""
        from repro_torch.serve.frontend import IndexService

        return IndexService(self.index)

    def search(self, batch: torch.Tensor) -> dict:
        res = self.index.search(batch, k=self.k, method=self.method)
        return {"ids": res.ids, "counts": res.counts, "threshold": res.threshold, "sims": None}

    def close(self) -> None:
        self.index = None
