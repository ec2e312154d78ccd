"""Core types for the GENIE match-count / top-k search framework."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import torch


class Engine(str, enum.Enum):
    """Match-count execution engines.

    EQ       -- signature equality compare (LSH-transformed data).
    RANGE    -- per-attribute interval predicate (relational data).
    MINSUM   -- multiset intersection  sum_v min(c_data, c_query)  (SA n-grams).
    IP       -- binary inner product (SA documents / sets).
    TANIMOTO -- minhash collision count estimating Jaccard over sets (FLASH).
    COSINE   -- sign-agreement count of sign-quantized vectors
                (simhash-angle cosine, Johnson et al. 1702.08734).

    EQ, TANIMOTO and COSINE have a registered MatchModel so far
    (core/engines.py); the names of the others are kept so keys and plans
    compare equal with the JAX package's.
    """

    EQ = "eq"
    RANGE = "range"
    MINSUM = "minsum"
    IP = "ip"
    TANIMOTO = "tanimoto"
    COSINE = "cosine"


class TopKMethod(str, enum.Enum):
    CPQ = "cpq"          # the paper's c-PQ (histogram gate, Theorem 3.1)
    SPQ = "spq"          # baseline: bucket k-selection (paper appendix / GPU-SPQ)
    SORT = "sort"        # baseline: full stable sort over all N


class SignatureLayout(str, enum.Enum):
    """Device-resident signature storage format.

    WIDE    -- one signature slot per array element.
    PACKED  -- bit/byte-packed signatures (COSINE sign words, TANIMOTO uint8
               buckets).  COSINE (32 signs per int32 word) and TANIMOTO
               (one byte per bucket id) have a packed format
               (core/packing.py); PACKED plans of the other engines are
               rejected at build/plan time.
    """

    WIDE = "wide"
    PACKED = "packed"


@dataclasses.dataclass(frozen=True)
class TopKResult:
    """Result of a top-k match-count query batch.

    ids:       int32 [Q, k]  object ids (-1 padding when fewer than k objects).
    counts:    int32 [Q, k]  match-count values, non-increasing along k.
    threshold: int32 [Q]     AT-1 per Theorem 3.1 == match count of the k-th object.
    """

    ids: torch.Tensor
    counts: torch.Tensor
    threshold: torch.Tensor

    @property
    def k(self) -> int:
        return self.ids.shape[-1]


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static parameters of a GENIE search."""

    k: int
    max_count: int                 # count-domain bound (e.g. m for LSH, #attrs for tables)
    method: TopKMethod = TopKMethod.CPQ
    candidate_cap: Optional[int] = None  # capacity of the candidate buffer (default 2k)
    use_kernel: bool = True        # CUDA kernels vs their plain PyTorch versions

    def cap(self) -> int:
        if self.candidate_cap is not None:
            return max(self.candidate_cap, self.k)
        return max(2 * self.k, self.k + 16)


@dataclasses.dataclass
class IndexStats:
    """Host-side statistics recorded at index-build time.

    The segment fields describe a SegmentedIndex (core/segments.py): a
    monolithic GenieIndex is the degenerate single-segment case
    (`n_segments=1`, empty per-segment lists, no compactions).
    """

    n_objects: int = 0
    n_lists: int = 0
    total_postings: int = 0
    max_list_len: int = 0
    bytes_device: int = 0
    build_seconds: float = 0.0
    # signature storage accounting: bytes the corpus occupies under each
    # layout (bytes_device equals whichever layout is actually resident;
    # bytes_signatures_packed is 0 for engines without a packed format)
    signature_layout: str = SignatureLayout.WIDE.value
    bytes_signatures_wide: int = 0
    bytes_signatures_packed: int = 0
    # per-segment build/compaction accounting (core/segments.py)
    n_segments: int = 1
    segment_rows: list[int] = dataclasses.field(default_factory=list)
    segment_build_seconds: list[float] = dataclasses.field(default_factory=list)
    compaction_count: int = 0
    compaction_seconds: float = 0.0
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
