"""The port's entry points on the CPU at tiny sizes: each example's `main`
(`python -m repro_torch.examples.<name>`) and `repro_torch.launch.serve`,
with `device="cpu"`; `launch/serve` against the JAX package's
`RetrievalService` on the same embeddings and LSH functions."""
import numpy as np
import pytest

from repro.serve import RetrievalService as JRetrievalService
from repro_torch.core.lsh import e2lsh
from repro_torch.data.pipeline import synthetic_documents
from repro_torch.examples import ann_kernel_space, quickstart, sequence_search, serve_batch
from repro_torch.launch import serve


def test_quickstart_runs_on_the_cpu(capsys):
    out = quickstart.main("cpu", n_points=3000, n_queries=32, m=64, batch=900, n_sub=800,
                          n_sub_queries=8)
    printed = capsys.readouterr().out
    for line in ("registered engines: eq, range, minsum, ip, tanimoto, cosine",
                 "top-1 self-retrieval: 1.000", "multiload(4 parts) counts identical: True",
                 "top-k identical to monolithic: True", "1 compaction, top-k identical: True"):
        assert line in printed
    assert out["self_retrieval"] == 1.0
    assert set(out["launches"]) == {"eq", "multiload", "cosine", "segmented", "compacted",
                                    "tanimoto"}
    assert not any(out["launches"].values())               # nothing launches on the CPU


def test_sequence_search_finds_the_source(capsys):
    out = sequence_search.main("cpu", n_seqs=500, target=123)
    assert out["best"] == {0.1: 123, 0.3: 123}
    assert "modification 10%: best candidate id=123" in capsys.readouterr().out


def test_ann_kernel_space_runs_on_the_cpu(capsys):
    out = ann_kernel_space.main("cpu", n_points=2000, n_test=200, m=32)
    assert 0.0 <= out["accuracy"] <= 1.0
    assert "1NN label prediction accuracy" in capsys.readouterr().out


def test_serve_batch_retrieves_and_decodes(capsys):
    out = serve_batch.main("cpu", n_docs=2000, n_queries=256, new_tokens=4)
    assert out["tokens"].shape == (4, 4)
    assert out["stats"].tokens_generated == 16
    assert "decoded 16 tokens" in capsys.readouterr().out


def test_launch_serve_equals_the_reference_service_on_the_same_embeddings(capsys):
    n_docs, n_queries, batches = 2000, 128, 2
    first = serve.main(["--device", "cpu", "--n-docs", str(n_docs), "--n-queries",
                        str(n_queries), "--batches", str(batches)])
    assert "top-1 self-retrieval" in capsys.readouterr().out
    docs = synthetic_documents(n_docs, seed=0)
    emb = first["embed"](docs).numpy()                  # the port's embeddings
    row = {text: i for i, text in enumerate(docs)}      # equal texts embed equally
    ref = JRetrievalService(embed_fn=lambda texts: emb[[row[t] for t in texts]],
                            m_override=128, n_buckets=1024)
    ref.add(docs)
    p = ref._params
    lsh = e2lsh.params_from_numpy(np.asarray(p.a), np.asarray(p.b), np.asarray(p.seeds),
                                  p.w, p.p, p.n_buckets, device="cpu")
    got = serve.run(n_docs=n_docs, n_queries=n_queries, batches=batches, device="cpu",
                    lsh_params=lsh)
    hits = 0
    for b in range(batches):
        ids = (np.arange(n_queries) * 7 + b) % n_docs
        res, _ = ref.search([docs[i] for i in ids], k=10)
        hits += int(np.sum(np.asarray(res.ids)[:, 0] == ids))
    assert got["self_retrieval"] == hits / (n_queries * batches)
    assert got["self_retrieval"] > 0.9


def test_importing_an_example_runs_nothing(capsys):
    import importlib

    for name in ("quickstart", "sequence_search", "ann_kernel_space", "serve_batch"):
        importlib.reload(importlib.import_module(f"repro_torch.examples.{name}"))
    importlib.reload(serve)
    assert capsys.readouterr().out == ""


def test_entry_points_need_the_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists here")
    for main in (quickstart.main, sequence_search.main, ann_kernel_space.main,
                 serve_batch.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([])
