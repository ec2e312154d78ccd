"""Deterministic synthetic data pipeline.

Provides reproducible token / embedding batches keyed by (seed, step, shard)
so every host in a multi-host job can independently materialise its shard of
the global batch (no cross-host data service needed), and a restart resumes
bit-identically from the checkpointed step cursor -- the data-side half of
fault tolerance.

The token stream is a Zipfian unigram mixture with in-sequence structure
(short Markov motifs), enough signal for loss-goes-down end-to-end tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticTokens:
    """Deterministic, seekable token batches."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        v = cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = 1.0 / ranks**1.1
        self.probs = probs / probs.sum()

    def batch(self, step: int) -> dict:
        d = self.data
        rng = np.random.default_rng((d.seed, step, d.host_id))
        toks = rng.choice(self.cfg.vocab, size=(d.host_batch, d.seq_len), p=self.probs)
        # motif structure: token t+1 = (token t + 1) % V with prob .5
        copy = rng.random((d.host_batch, d.seq_len)) < 0.5
        for j in range(1, d.seq_len):
            toks[:, j] = np.where(copy[:, j], (toks[:, j - 1] + 1) % self.cfg.vocab, toks[:, j])
        out = {"tokens": toks.astype(np.int32)}
        if self.cfg.family == "vlm":
            p = self.cfg.n_patches
            out["patch_embeds"] = rng.standard_normal(
                (d.host_batch, p, self.cfg.d_model)).astype(np.float32) * 0.02
            out["tokens"] = out["tokens"][:, : d.seq_len - p]
        if self.cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (d.host_batch, d.seq_len, self.cfg.d_model)).astype(np.float32) * 0.02
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def synthetic_points(n: int, dim: int, n_clusters: int = 32, seed: int = 0,
                     cluster_std: float = 0.3) -> tuple[np.ndarray, np.ndarray]:
    """Clustered points for the GENIE ANN experiments (labels = cluster id,
    the OCR-style 1NN-prediction ground truth)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)) * 2.0
    labels = rng.integers(0, n_clusters, n)
    pts = centers[labels] + rng.standard_normal((n, dim)) * cluster_std
    return pts.astype(np.float32), labels.astype(np.int32)


def synthetic_sequences(n: int, length: int = 40, alphabet: str = "abcdefghij",
                        seed: int = 0) -> list[str]:
    """Random sequences (DBLP-title stand-ins)."""
    rng = np.random.default_rng(seed)
    a = np.array(list(alphabet))
    return ["".join(a[rng.integers(0, len(a), length)]) for _ in range(n)]


def mutate_sequence(s: str, rate: float, alphabet: str = "abcdefghij", seed: int = 0) -> str:
    """Paper section VI-A1: modify `rate` fraction of characters."""
    rng = np.random.default_rng(seed)
    chars = list(s)
    k = int(round(rate * len(chars)))
    idx = rng.choice(len(chars), size=k, replace=False)
    for i in idx:
        chars[i] = alphabet[rng.integers(0, len(alphabet))]
    return "".join(chars)


def synthetic_documents(n: int, vocab_words: int = 5000, words_per_doc: int = 12,
                        seed: int = 0) -> list[str]:
    """Short documents (Tweets stand-ins), Zipfian word choice."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_words + 1, dtype=np.float64)
    probs = (1.0 / ranks**1.05); probs /= probs.sum()
    docs = []
    for _ in range(n):
        ids = rng.choice(vocab_words, size=words_per_doc, p=probs)
        docs.append(" ".join(f"w{int(i)}" for i in ids))
    return docs
