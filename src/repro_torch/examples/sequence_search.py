"""SA sequence search under edit distance (paper section V-A): n-gram
decomposition, match-count filtering, batched DP verification, and the
Theorem 5.2 exactness certificate.

    python -m repro_torch.examples.sequence_search [--device cpu]

The counterpart of `examples/sequence_search.py`.  `main` returns the best
candidate of each modification rate and the kernel launches of each search.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import GenieIndex
from repro_torch.core.sa import ngram, verify
from repro_torch.data.pipeline import mutate_sequence, synthetic_sequences
from repro_torch.device import resolve_device
from repro_torch.kernels.common import launches_during


def main(device=None, *, n_seqs: int = 5_000, length: int = 40, target: int = 1234,
         n: int = 3, v: int = 4096, k: int = 32) -> dict:
    dev = resolve_device(device)
    seqs = synthetic_sequences(n_seqs, length=length, seed=0)
    index = GenieIndex.build_minsum(ngram.count_vectors(seqs, n, v), max_count=127,
                                    use_kernel=dev.type != "cpu", device=dev)
    out = {"best": {}, "launches": {}}
    for rate in (0.1, 0.3):
        query = mutate_sequence(seqs[target], rate, seed=7)
        qv = torch.from_numpy(ngram.count_vector(query, n, v)[None]).to(dev)
        res, out["launches"][rate] = launches_during(lambda: index.search(qv, k=k))
        ids = res.ids[0].cpu().numpy()

        cand = [seqs[i] if i >= 0 else "" for i in ids]
        enc, lens = ngram.encode_sequences(cand, 48)
        qenc, qlen = ngram.encode_sequences([query], 48)
        checked = verify.verify_topk(
            torch.from_numpy(qenc[0]).to(dev), int(qlen[0]), torch.from_numpy(enc).to(dev),
            torch.from_numpy(lens).to(dev), res.counts[0], k=1, n=n)
        best = int(ids[int(checked["order"][0])])
        out["best"][rate] = best
        print(f"modification {rate:.0%}: best candidate id={best} "
              f"(target {target}, ed={int(checked['edit_distances'][0])}, "
              f"certified_exact={bool(checked['certified_exact'])})")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
