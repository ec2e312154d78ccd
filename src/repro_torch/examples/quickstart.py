"""GENIE quickstart: build an inverted index through the MatchModel registry,
run a batched tau-ANN search, and inspect the c-PQ guarantees.

    python -m repro_torch.examples.quickstart [--device cpu]

The counterpart of `examples/quickstart.py`.  On the card every index
launches the CUDA kernels; on the CPU it takes their plain versions.
`main` returns what it printed, and the kernel launches of each search.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Engine, GenieIndex, SegmentedIndex, TopKMethod, engines
from repro_torch.core import lsh as lsh_lib
from repro_torch.core.lsh import tau_ann
from repro_torch.data.pipeline import synthetic_points
from repro_torch.device import resolve_device
from repro_torch.kernels.common import launches_during


def main(device=None, *, n_points: int = 20_000, dim: int = 32, n_clusters: int = 64,
         n_queries: int = 128, m=None, batch: int = 6000, n_sub: int = 4000,
         n_sub_queries: int = 16) -> dict:
    dev = resolve_device(device)
    use_kernel = dev.type != "cpu"
    out = {"launches": {}}
    # 0. the registry is the system's single dispatch point: every engine is
    #    one descriptor, every search path resolves through it
    print("registered engines:", ", ".join(e.value for e in engines.available()))
    print("registered LSH schemes:", ", ".join(lsh_lib.scheme_names()))

    # 1. data: clustered points (SIFT-like stand-in)
    pts, _ = synthetic_points(n_points, dim=dim, n_clusters=n_clusters, seed=0)
    pts_t = torch.from_numpy(pts).to(dev)

    # 2. LSH transform via the scheme registry: the paper's practical m
    #    (Fig 8) at eps = delta = 0.06
    m = m or tau_ann.required_m(0.06, 0.06)
    print(f"hash functions m = {m} (paper: 237; Theorem 4.1 bound: "
          f"{tau_ann.m_theorem41(0.06, 0.06)})")
    scheme = lsh_lib.get_scheme("e2lsh")
    params = scheme.make_params(torch.Generator().manual_seed(0), d=dim, m=m, w=4.0,
                                n_buckets=67, device=dev)
    sigs = scheme.hash_points(params, pts_t)

    # 3. build the index through the generic registry entry point
    index = GenieIndex.build(Engine.EQ, sigs, use_kernel=use_kernel, device=dev)
    print(f"index: {index.stats.n_objects} objects, "
          f"{index.stats.bytes_device/1e6:.1f} MB on device "
          f"(engine={index.stats.extra['engine']})")

    # 4. batched search: noisy queries
    rng = np.random.default_rng(1)
    q = pts[:n_queries] + rng.standard_normal((n_queries, dim)).astype(np.float32) * 0.1
    qsigs = scheme.hash_points(params, torch.from_numpy(q).to(dev))
    res, out["launches"]["eq"] = launches_during(
        lambda: index.search(qsigs, k=10, method=TopKMethod.CPQ))
    ids = res.ids.cpu().numpy()
    out["self_retrieval"] = float(np.mean(ids[:, 0] == np.arange(n_queries)))
    print(f"top-1 self-retrieval: {out['self_retrieval']:.3f}")
    print(f"MC_k threshold (Theorem 3.1, AT-1) for query 0: {int(res.threshold[0])}")
    sims = tau_ann.mle_similarity(res.counts[:1].cpu().numpy(), m)
    print(f"similarity estimates (Eqn 7) for query 0: {np.round(sims, 3)}")

    # 5. the same index streamed as 4 parts (paper section III-D) -- identical
    #    counts, any registered engine
    parts, out["launches"]["multiload"] = launches_during(
        lambda: index.search_multiload(qsigs, k=10, n_parts=4))
    out["multiload_same"] = bool(torch.equal(res.counts, parts.counts))
    print(f"multiload(4 parts) counts identical: {out['multiload_same']}")

    # 6. the same machinery, different measures: sign-quantized cosine
    #    (simhash bits -> COSINE sign agreements) and Jaccard sketches
    #    (minhash -> TANIMOTO collision counts, FLASH-style)
    sub = pts_t[:n_sub]
    qs = torch.from_numpy(q[:n_sub_queries]).to(dev)
    sh = lsh_lib.get_scheme("simhash")
    sh_params = sh.make_params(torch.Generator().manual_seed(1), d=dim, m=128, device=dev)
    cos_idx = GenieIndex.build(sh.engine, sh.hash_points(sh_params, sub),
                               use_kernel=use_kernel, device=dev)
    cres, out["launches"]["cosine"] = launches_during(
        lambda: cos_idx.search(sh.hash_points(sh_params, qs), k=5))
    cos_hat = sh.mle(cres.counts[:1].cpu().numpy(), cos_idx.max_count)
    out["cosine_self_retrieval"] = float(np.mean(
        cres.ids.cpu().numpy()[:, 0] == np.arange(n_sub_queries)))
    print(f"COSINE engine: top-1 self-retrieval {out['cosine_self_retrieval']:.3f}, "
          f"cos estimates q0: {np.round(cos_hat[0], 3)}")

    # 6.5 incremental growth: seal each arriving batch into an immutable
    #     segment (O(batch) per add, no rebuild), search across segments with
    #     the exact cap-buffer merge, then compact -- results never change
    seg = SegmentedIndex(engine=Engine.EQ, max_count=m, use_kernel=use_kernel, device=dev)
    for start in range(0, sigs.shape[0], batch):       # uneven final batch
        seg.add(sigs[start:start + batch])
    sres, out["launches"]["segmented"] = launches_during(lambda: seg.search(qsigs, k=10))
    out["segmented_same"] = bool(torch.equal(res.ids, sres.ids))
    print(f"segmented add ({seg.stats.n_segments} segments, rows "
          f"{seg.stats.segment_rows}): top-k identical to monolithic: "
          f"{out['segmented_same']}")
    seg.compact(max_segments=1)
    sres, out["launches"]["compacted"] = launches_during(lambda: seg.search(qsigs, k=10))
    out["compacted_same"] = bool(torch.equal(res.ids, sres.ids))
    print(f"after compact(1): {seg.stats.n_segments} segment, "
          f"{seg.stats.compaction_count} compaction, top-k identical: "
          f"{out['compacted_same']}")

    mh = lsh_lib.get_scheme("minhash")
    mh_params = mh.make_params(torch.Generator().manual_seed(2), d=dim, m=96,
                               n_buckets=8192, device=dev)
    tan_idx = GenieIndex.build(mh.engine, mh.hash_points(mh_params, sub),
                               use_kernel=use_kernel, device=dev)
    tres, out["launches"]["tanimoto"] = launches_during(
        lambda: tan_idx.search(mh.hash_points(mh_params, qs), k=5))
    out["tanimoto_self_retrieval"] = float(np.mean(
        tres.ids.cpu().numpy()[:, 0] == np.arange(n_sub_queries)))
    print(f"TANIMOTO engine: top-1 self-retrieval {out['tanimoto_self_retrieval']:.3f}, "
          f"Jaccard MLE q0: {np.round(mh.mle(tres.counts[:1].cpu().numpy(), 96)[0], 3)}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
