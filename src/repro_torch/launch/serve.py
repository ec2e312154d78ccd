"""Serving launcher: batched GENIE similarity search over documents embedded
through an LM's embedding table.

    python -m repro_torch.launch.serve --arch smollm-360m-smoke \
        --n-docs 20000 --n-queries 1024 --k 10 [--device cpu]

The counterpart of `repro/launch/serve.py`, with its arguments and `--device`
(default: the card).  It prints what the reference prints; `run` returns it,
with the kernel launches of each search, the service and its documents.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.sa import document
from repro_torch.data.pipeline import synthetic_documents
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.common import launches_during
from repro_torch.models.registry import get_api, get_config, list_archs
from repro_torch.serve import RetrievalService


def table_embedder(table: torch.Tensor, n_buckets: int):
    """Documents -> binary word vectors [n, n_buckets] projected through the
    first n_buckets rows of an embedding table, on the table's device."""
    def embed(texts):
        vecs = document.binary_vectors(list(texts), n_buckets).astype(np.float32)
        return torch.from_numpy(vecs).to(table.device) @ table[:n_buckets]
    return embed


def run(arch: str = "smollm-360m-smoke", n_docs: int = 20_000, n_queries: int = 1024,
        k: int = 10, batches: int = 4, device=None, lsh_params=None) -> dict:
    """`lsh_params`: e2lsh parameters handed to the service in place of its
    seeded draw (RetrievalService(params=))."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device=dev)
    embed = table_embedder(params["embed"].float(), min(cfg.vocab, 512))

    docs = synthetic_documents(n_docs, seed=0)
    svc = RetrievalService(embed_fn=embed, m_override=128, n_buckets=1024, device=dev,
                           params=lsh_params)
    synchronize(dev)
    t0 = time.perf_counter()
    svc.add(docs)
    synchronize(dev)
    index_seconds = time.perf_counter() - t0
    print(f"indexed {n_docs} docs in {index_seconds:.2f}s")

    total, hits, launches = 0, 0, []
    t0 = time.perf_counter()
    for b in range(batches):
        ids = (np.arange(n_queries) * 7 + b) % n_docs
        (res, _), counted = launches_during(
            lambda: svc.search([docs[i] for i in ids], k=k))
        launches.append(counted)
        hits += int(np.sum(res.ids[:, 0].cpu().numpy() == ids))
        total += n_queries
    synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{total} queries in {dt:.2f}s -> {total/dt:.0f} qps; "
          f"top-1 self-retrieval {hits/total:.3f}")
    return dict(index_seconds=index_seconds, queries=total, seconds=dt, qps=total / dt,
                self_retrieval=hits / total, launches=launches, embed=embed, service=svc,
                docs=docs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-smoke", choices=list_archs())
    ap.add_argument("--n-docs", type=int, default=20_000)
    ap.add_argument("--n-queries", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, args.n_docs, args.n_queries, args.k, args.batches, args.device)


if __name__ == "__main__":
    main()
