"""The program under test for a short-document deployment: `DocumentIndex`
of `repro_torch` (core/sa/document.py) over `SegmentedIndex(Engine.IP)`,
WIDE int8 word vectors, c-PQ, no autotune.  The corpus goes in as `segments`
adds of word ids, which the program encodes on the device; a search takes
the queries' word ids, so it runs encode -> plan -> IP count -> histogram ->
c-PQ gate, compaction and final order -> merge."""
from __future__ import annotations


class System:
    def __init__(self, cfg: dict, seed: int, ref, inp: dict, device):
        from repro_torch.core import TopKMethod
        from repro_torch.core.sa import DocumentIndex

        self.k = cfg["k"]
        self.method = TopKMethod.CPQ
        self.index = DocumentIndex(ref.vocabulary(cfg), cfg["n_buckets"], cfg["max_count"],
                                   device=device)
        for s in range(cfg["segments"]):
            self.index.add(ref.corpus_chunk(cfg, seed, inp, s, device))

    def prepare(self, raw_pool):
        """The queries as the program takes them: word ids."""
        return raw_pool

    def backend(self):
        """What the program's serving front-end takes as a tenant: the IP
        index, with the queries' word ids encoded at dispatch."""
        from repro_torch.serve.frontend import IndexService

        return IndexService(self.index.index, query_adapter=self.index.encode)

    def search(self, batch) -> dict:
        res = self.index.search(batch, k=self.k, method=self.method)
        return {"ids": res.ids, "counts": res.counts, "threshold": res.threshold, "sims": None}

    def close(self) -> None:
        self.index = None
