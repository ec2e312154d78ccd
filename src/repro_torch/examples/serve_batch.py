"""End-to-end serving example (the paper's kind: high-throughput batched
similarity queries).  A GENIE RetrievalService indexes document embeddings
produced by a small LM from the model zoo; batches of 1024 queries are
answered with tau-ANN search + c-PQ selection, and the LM decodes a
continuation -- retrieval-augmented serving with the paper's technique as
the retrieval layer.

    python -m repro_torch.examples.serve_batch [--device cpu]

The counterpart of `examples/serve_batch.py`.  `main` returns what it
printed, and the kernel launches of the search.
"""
import argparse
import time

import numpy as np

from repro_torch.data.pipeline import DataConfig, SyntheticTokens, synthetic_documents
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.common import launches_during
from repro_torch.launch.serve import table_embedder
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve import RetrievalService, ServeEngine


def main(device=None, *, arch: str = "smollm-360m-smoke", n_docs: int = 20_000,
         n_queries: int = 1024, new_tokens: int = 16) -> dict:
    dev = resolve_device(device)
    # --- a small LM from the zoo provides the embedding + decode stack ---
    cfg = get_config(arch)
    api = get_api(cfg)
    params = api.init_params(cfg, 0, device=dev)
    # mean-pooled binary word vectors projected through the embedding table
    # (toy embedder; production would mean-pool hidden states)
    embed = table_embedder(params["embed"].float(), 512)

    # --- index the documents with GENIE ---
    docs = synthetic_documents(n_docs, seed=3)
    svc = RetrievalService(embed_fn=embed, m_override=128, n_buckets=1024, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    svc.add(docs)
    synchronize(dev)
    print(f"indexed {len(docs)} docs in {time.perf_counter()-t0:.2f}s (m={svc.m})")

    # --- batched retrieval: 1024 queries per batch (paper's regime) ---
    picked = np.arange(0, 4 * n_queries, 4) % n_docs
    queries = [docs[i] for i in picked]
    t0 = time.perf_counter()
    (res, _), launches = launches_during(lambda: svc.search(queries, k=5))
    synchronize(dev)
    dt = time.perf_counter() - t0
    hit1 = float(np.mean(res.ids[:, 0].cpu().numpy() == picked))
    print(f"searched {len(queries)} queries in {dt:.2f}s "
          f"({len(queries)/dt:.0f} qps); top-1 self-retrieval {hit1:.3f}")

    # --- decode a continuation ---
    eng = ServeEngine(cfg, api, params, cache_cap=64)
    batch = SyntheticTokens(cfg, DataConfig(global_batch=4, seq_len=16)).batch(0)
    toks, stats = eng.generate(batch, max_new_tokens=new_tokens)
    print(f"decoded {stats.tokens_generated} tokens at "
          f"{stats.decode_tokens_per_s:.0f} tok/s ({dev.type})")
    return dict(self_retrieval=hit1, qps=len(queries) / dt, tokens=toks, stats=stats,
                launches={"search": launches})


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
