"""GENIE dataset configurations mirroring the paper's five experiments
(section VI-A1), with reduced sizes for CPU runs and the full-scale shapes
the dry-run (`launch/dryrun.py`) accounts for.  The counterpart of
`repro/configs/genie_datasets.py`, field for field.

    OCR        3.5M x 1156-dim points, RBH (Laplacian kernel), rehash to 8192
    SIFT       4.5M x 128-dim points, E2LSH (l2), 67 buckets
    SIFT_LARGE 36M SIFT features (multi-loading)
    DBLP       5.0M title sequences, 3-grams, K=32 candidates
    Tweets     6.8M short documents, word vectors
    Adult      0.98M tuples x 14 attributes, 1024 bins, range +-50
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.lsh import tau_ann


@dataclasses.dataclass(frozen=True)
class GenieDatasetConfig:
    name: str
    engine: str            # eq | minsum | ip | range
    n_objects: int         # full-scale (dry-run / roofline)
    n_objects_bench: int   # reduced (CPU benchmarks)
    dim: int               # raw dimensionality / #attributes
    m: int                 # hash functions (EQ) or vocab buckets (minsum/ip)
    n_buckets: int         # rehash domain D
    default_k: int = 100
    queries_per_batch: int = 1024
    extra: tuple = ()


EPS = DELTA = 0.06
M_PRACTICAL = 237          # paper Fig 8 (tau_ann.required_m(0.06, 0.06) gives 238)


def m_paper() -> int:
    return M_PRACTICAL


DATASETS = {
    "ocr": GenieDatasetConfig(
        name="ocr", engine="eq", n_objects=3_500_000, n_objects_bench=20_000,
        dim=1156, m=M_PRACTICAL, n_buckets=8192,
    ),
    "sift": GenieDatasetConfig(
        name="sift", engine="eq", n_objects=4_500_000, n_objects_bench=20_000,
        dim=128, m=M_PRACTICAL, n_buckets=67,
    ),
    "sift_large": GenieDatasetConfig(
        name="sift_large", engine="eq", n_objects=36_000_000, n_objects_bench=60_000,
        dim=128, m=M_PRACTICAL, n_buckets=67,
    ),
    "dblp": GenieDatasetConfig(
        name="dblp", engine="minsum", n_objects=5_000_000, n_objects_bench=20_000,
        dim=40, m=4096, n_buckets=4096, default_k=1,
    ),
    "tweets": GenieDatasetConfig(
        name="tweets", engine="ip", n_objects=6_800_000, n_objects_bench=20_000,
        dim=16, m=8192, n_buckets=8192,
    ),
    "adult": GenieDatasetConfig(
        name="adult", engine="range", n_objects=980_000, n_objects_bench=20_000,
        dim=14, m=14, n_buckets=1024,
    ),
}
