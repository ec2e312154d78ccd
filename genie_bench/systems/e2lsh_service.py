"""The program under test for an E2LSH deployment: `RetrievalService(scheme=
"e2lsh")` of `repro_torch`, WIDE signatures, c-PQ, no autotune.  The
benchmark's E2LSH functions are handed over through `load_params`; the
corpus goes in as `segments` adds of raw points, a search takes raw query
points, so a search runs hash -> plan -> match -> histogram -> c-PQ gate,
compaction and final order -> merge -> MLE."""
from __future__ import annotations

import torch


class System:
    def __init__(self, cfg: dict, seed: int, ref, inp: dict, device):
        from repro_torch.core import TopKMethod
        from repro_torch.core.lsh import e2lsh
        from repro_torch.serve import RetrievalService

        self.k = cfg["k"]
        self.method = TopKMethod.CPQ
        self.service = RetrievalService(scheme="e2lsh", m_override=cfg["m"],
                                        n_buckets=cfg["n_buckets"], w=float(cfg["w"]),
                                        max_segments=cfg["segments"], device=device)
        self.service.load_params(e2lsh.params_from_numpy(
            inp["a"].cpu().numpy(), inp["b"].cpu().numpy(), inp["seeds"].cpu().numpy(),
            w=float(cfg["w"]), p=cfg["p"], n_buckets=cfg["n_buckets"], device=device))
        per = ref.rows_per_add(cfg)
        for s in range(cfg["segments"]):
            self.service.add(range(s * per, (s + 1) * per),
                             embeddings=ref.corpus_chunk(cfg, seed, inp, s, device))

    def prepare(self, raw_pool: torch.Tensor) -> torch.Tensor:
        """The queries as the program takes them: raw points."""
        return raw_pool

    def backend(self):
        """What the program's serving front-end takes as a tenant."""
        return self.service

    def search(self, batch: torch.Tensor) -> dict:
        res, sims = self.service.search(None, k=self.k, embeddings=batch, method=self.method)
        return {"ids": res.ids, "counts": res.counts, "threshold": res.threshold,
                "sims": torch.from_numpy(sims)}

    def close(self) -> None:
        self.service = None
