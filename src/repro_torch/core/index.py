"""GenieIndex: the user-facing GENIE index (paper sections II-III).

Holds device-resident transformed data (LSH signatures, sign vectors) and resolves
*everything* engine-specific -- data preparation, query canonicalisation,
kernel-vs-reference match dispatch, index statistics, count-domain bounds --
through the MatchModel registry (core/engines.py).  Searches are thin
adapters over the unified planner (core/plan.py): `search` builds a
MONOLITHIC QueryPlan and delegates to the one executor that owns match
dispatch, pad masking, top-k selection, and merging.

    index = GenieIndex.build(Engine.EQ, sigs)            # any registered engine
    index = GenieIndex.build_lsh(sigs, max_count=m)      # named alias
    index = GenieIndex.build_cosine(vectors, signature_layout="packed")
    index = GenieIndex.build_tanimoto(minhash_sigs, signature_layout="packed")
    index = GenieIndex.build_relational(discrete_tuples)   # RANGE
    index = GenieIndex.build_minsum(count_vectors, max_count=127)
    index = GenieIndex.build_ip(binary_vectors, max_count=16)
    result = index.search(query_sigs, k=100)             # TopKResult
    result = index.search((lo, hi), k=100)               # RANGE: intervals

    result = index.search_multiload(query_sigs, k=100, n_parts=16)

`device=None` places the index on the card and raises when there is none;
`device="cpu"` runs the plain PyTorch path.  `build` also makes the segment's
routing summary (`summary`, core/routing.py) from the prepared WIDE tensor,
on its device, before any packing.  `search` and `search_multiload` take the
reference's `tile_overrides` / `autotune` keywords (core/autotune.py), with
the stored width as the cache's width hint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core import autotune as _autotune
from repro_torch.core import engines as _engines
from repro_torch.core import plan as _plan
from repro_torch.core import routing as _routing
from repro_torch.core.types import (Engine, IndexStats, SignatureLayout,
                                    TopKMethod, TopKResult)
from repro_torch.device import DeviceLike, resolve_device, synchronize


@dataclasses.dataclass
class GenieIndex:
    engine: Engine
    max_count: int
    data: torch.Tensor                     # EQ: sigs int32 [N, m]; RANGE:
    #                                        tuples int32 [N, d]; MINSUM:
    #                                        counts int32 [N, V]; IP: word
    #                                        vectors [N, V] (caller's dtype);
    #                                        TANIMOTO: sketches int32 or
    #                                        uint8 [N, m]; COSINE: signs int8
    #                                        [N, V] or words int32 [N, W]
    stats: IndexStats = dataclasses.field(default_factory=IndexStats)
    use_kernel: bool = True
    # storage format of `data` (core/packing.py); PACKED indexes hold the
    # packed tensor and dispatch the packed match kernels
    signature_layout: SignatureLayout = SignatureLayout.WIDE
    # seal-time routing summary (core/routing.py); None for a segment
    # assembled by hand outside build()
    summary: Optional[_routing.SegmentSummary] = None

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def build(cls, engine: Engine | str, data, max_count: int | None = None,
              use_kernel: bool = True,
              signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
              device: DeviceLike = None) -> "GenieIndex":
        """Any registered engine, one code path.

        `max_count` defaults to the engine's derived count bound (m for EQ,
        #attributes for RANGE, V for COSINE); engines without a derivable
        bound (MINSUM, IP) require it explicitly.

        `signature_layout=PACKED` packs the prepared tensor once at seal time
        (COSINE signs -> int32-word bitfields, TANIMOTO buckets -> uint8) for
        engines with a packed
        format; counts and top-k results are bit-for-bit identical to WIDE,
        only the device footprint and the match's memory traffic shrink.
        """
        dev = resolve_device(device)
        model = _engines.get(engine)
        layout = model.require_layout(signature_layout)
        # perf_counter, not time(): a wall-clock (NTP) step must never record
        # a negative build duration
        t0 = time.perf_counter()
        arr = model.prepare_data(data, dev)
        # stats, postings, the count bound and the routing summary read the
        # *logical* WIDE shape: resolve them before packing (the packed width
        # is words, not slots)
        stats = model.build_stats(arr)
        summary = _routing.summarize(model.engine, arr)
        max_count = model.resolve_max_count(arr, max_count)
        if layout is SignatureLayout.PACKED:
            arr = model.pack_data(arr)
            stats.signature_layout = layout.value
            stats.bytes_device = int(arr.numel()) * arr.element_size()
        # the copy to the device is asynchronous; without this the timer
        # reports enqueue time, not build time
        synchronize(dev)
        stats.build_seconds = time.perf_counter() - t0
        return cls(engine=model.engine, max_count=max_count,
                   data=arr, stats=stats, use_kernel=use_kernel,
                   signature_layout=layout, summary=summary)

    @classmethod
    def build_lsh(cls, signatures, max_count: int | None = None,
                  use_kernel: bool = True, device: DeviceLike = None):
        """EQ engine over LSH signatures int32 [N, m]."""
        return cls.build(Engine.EQ, signatures, max_count=max_count,
                         use_kernel=use_kernel, device=device)

    @classmethod
    def build_minsum(cls, count_vectors, max_count: int, use_kernel: bool = True,
                     device: DeviceLike = None):
        """MINSUM engine over n-gram count vectors int [N, V]."""
        return cls.build(Engine.MINSUM, count_vectors, max_count=max_count,
                         use_kernel=use_kernel, device=device)

    @classmethod
    def build_ip(cls, binary_vectors, max_count: int, use_kernel: bool = True,
                 device: DeviceLike = None):
        """IP engine over binary word vectors [N, V]."""
        return cls.build(Engine.IP, binary_vectors, max_count=max_count,
                         use_kernel=use_kernel, device=device)

    @classmethod
    def build_relational(cls, discrete_tuples, use_kernel: bool = True,
                         device: DeviceLike = None):
        """RANGE engine over discretized tuples int32 [N, d]."""
        return cls.build(Engine.RANGE, discrete_tuples, use_kernel=use_kernel,
                         device=device)

    @classmethod
    def build_tanimoto(cls, minhash_sigs, max_count: int | None = None,
                       use_kernel: bool = True,
                       signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
                       device: DeviceLike = None):
        """TANIMOTO engine over minhash sketches int32 [N, m]."""
        return cls.build(Engine.TANIMOTO, minhash_sigs, max_count=max_count,
                         use_kernel=use_kernel, signature_layout=signature_layout,
                         device=device)

    @classmethod
    def build_cosine(cls, vectors, max_count: int | None = None,
                     use_kernel: bool = True,
                     signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
                     device: DeviceLike = None):
        """COSINE engine over raw vectors [N, V] (sign-quantized at build)."""
        return cls.build(Engine.COSINE, vectors, max_count=max_count,
                         use_kernel=use_kernel, signature_layout=signature_layout,
                         device=device)

    # ------------------------------------------------------------------
    # Matching + selection
    # ------------------------------------------------------------------
    @property
    def model(self) -> _engines.MatchModel:
        return _engines.get(self.engine)

    def prepare_queries(self, queries):
        """Raw queries -> canonical form on this index's device."""
        return self.model.prepare_queries_for(queries, self.data.device,
                                              self.signature_layout)

    def match_counts(self, queries) -> torch.Tensor:
        """counts int32 [Q, N] under this index's engine."""
        return self.model.match_counts(self.data, queries, self.use_kernel,
                                       self.signature_layout)

    def search(self, queries, k: int, method: TopKMethod = TopKMethod.CPQ,
               candidate_cap: int | None = None,
               tile_overrides=None, autotune=None) -> TopKResult:
        plan = _plan.plan_search(
            self.engine, k, self.max_count, layout=_plan.Layout.MONOLITHIC,
            part_rows=(self.stats.n_objects,), method=method,
            candidate_cap=candidate_cap, use_kernel=self.use_kernel,
            signature_layout=self.signature_layout,
            tile_overrides=tile_overrides,
            autotune=_autotune.resolve_cache(autotune, self.data.device),
            tune_width=int(self.data.shape[1]),
        )
        return _plan.execute(plan, self.data, self.prepare_queries(queries))

    def search_multiload(self, queries, k: int, n_parts: int,
                         method: TopKMethod = TopKMethod.CPQ,
                         candidate_cap: int | None = None,
                         tile_overrides=None, autotune=None) -> TopKResult:
        """Paper section III-D: split this index into parts and stream them.

        Works for every registered engine: the planned layout pads parts with
        the engine's fill and the executor masks pad rows out of the merged
        result.
        """
        plan = _plan.plan_search(
            self.engine, k, self.max_count, layout=_plan.Layout.MULTILOAD,
            n_parts=n_parts, n_objects=self.stats.n_objects, method=method,
            candidate_cap=candidate_cap, use_kernel=self.use_kernel,
            signature_layout=self.signature_layout,
            tile_overrides=tile_overrides,
            autotune=_autotune.resolve_cache(autotune, self.data.device),
            tune_width=int(self.data.shape[1]),
        )
        chunks = _plan.pad_and_stack(plan, self.data)
        return _plan.execute(plan, chunks, self.prepare_queries(queries))
