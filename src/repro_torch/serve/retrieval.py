"""GENIE retrieval service: the paper's technique as a first-class serving
feature.

A RetrievalService wraps an embedding function (or takes raw feature vectors),
an LSH scheme resolved from the scheme registry (core/lsh/__init__.py), and a
SegmentedIndex; `add`/`search` give tau-ANN retrieval at batch 1024+, the
paper's throughput regime.

Selecting a scheme by name selects the whole engine stack: each LshScheme
names the match engine that consumes its signatures (e2lsh/rbh -> EQ bucket
collisions, minhash -> TANIMOTO sketch collisions, simhash -> COSINE sign
agreements) and the MLE that converts match counts back to similarity
estimates, so `RetrievalService(scheme="simhash")` serves quantized cosine
and `scheme="minhash"` serves Jaccard with no other change.

`signature_layout="packed"` seals every segment bit/byte-packed (simhash ->
COSINE sign words, 32 signs per int32 word, 8x less device memory; minhash ->
TANIMOTO uint8 bucket ids, 4x less, when n_buckets <= 254 -- `pack_buckets`
refuses larger ids, as in the reference; core/packing.py): results are
identical to WIDE, and a search runs the fused match -> count -> per-tile
top-k kernel, which never writes the [Q, N] count matrix.  WIDE-only engines
(e2lsh/rbh -> EQ) reject it at construction.

`add` may be called repeatedly: each batch is hashed once and sealed into an
immutable index *segment* (core/segments.py) -- O(batch) device work per
call, no rebuild or re-upload of earlier batches.  When the segment count
exceeds `max_segments` the index compacts adjacent segments down to
`max_segments // 2`, so steady-state search cost stays flat while adds stay
cheap.  Search merges per-segment candidate buffers exactly (segments
partition the object set), so results are identical to a monolithic rebuild.

Device rule: `device=None` means the card, and raises when there is none;
`device="cpu"` runs the plain PyTorch path.  `add`/`search` accept numpy
arrays or tensors; a tensor already on the device is not copied through the
host.  The E2LSH and simhash projections are float32 matrix products: the
service turns TF32 off for CUDA matmuls when it is built, because a TF32
product would move points across bucket boundaries or flip signs near 0.

`search(routing=, nprobe=)` puts the coarse router (core/routing.py) in
front of the exact match; the service keeps one Router and rebuilds it only
when the corpus fingerprint changes (an add or a compaction).

`autotune=` (True, a path, or an AutotuneCache; core/autotune.py) is
consulted by every search plan, resolved against the service's device; a
miss or a fingerprint mismatch keeps the defaults.  `tune()` measures the
serving shape and installs the winner.

Sharded serving: pass `mesh=` (a `DeviceMesh`, launch/mesh.py) and `search`
plans the segmented corpus across the mesh via the DISTRIBUTED layout --
segments are concatenated in global-id order, padded up to mesh
divisibility, sharded over every mesh axis (a DTensor placed with
`distributed.data_sharding`), and served through the same unified executor
(core/plan.py) as single-device search, so results are identical.  The
sharded placement is cached between searches and refreshed only when the
corpus changes (an `add` or a compaction).  The mesh fixes the device type:
`device` defaults to it.  Like the reference's single controller, which
holds its segments on its default device beside the sharded copy, every
rank of an SPMD program holds the whole segmented index (every rank calls
`add` and `search` with the same arguments), and the placement is a second
copy of the corpus (ROADMAP: open for a run on several cards).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import SegmentedIndex, TopKMethod, distributed
from repro_torch.core import engines as engines_lib
from repro_torch.core import lsh as lsh_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import routing as routing_lib
from repro_torch.core.lsh import tau_ann
from repro_torch.core.types import SignatureLayout
from repro_torch.device import DeviceLike, resolve_device, tensor_from


@dataclasses.dataclass
class RetrievalService:
    # raw items -> [n, d] embeddings; may stay None when every call passes
    # `embeddings=` itself
    embed_fn: Optional[Callable] = None
    scheme: str = "e2lsh"                          # any registered LshScheme name
    eps: float = 0.06
    delta: float = 0.06
    n_buckets: int = 8192
    w: float = 4.0
    sigma: float = 1.0
    seed: int = 0
    m_override: Optional[int] = None
    max_segments: int = 16                         # compaction trigger for add()
    mesh: Optional[object] = None                  # a DeviceMesh: serve sharded
    signature_layout: SignatureLayout | str = SignatureLayout.WIDE
    # measured-knob cache (core/autotune.py): True = the default per-user
    # cache file, a path = that file, an AutotuneCache = itself.  Consulted
    # by every search plan; a miss or a hardware-fingerprint mismatch keeps
    # the defaults.  Not part of batch_compat_key: the front-end coalesces
    # per tenant and a tenant's autotune spec is fixed for the service's
    # lifetime.
    autotune: object = None
    use_kernel: bool = True                        # CUDA kernels vs plain PyTorch
    device: DeviceLike = None                      # None = the card
    # scheme parameters handed over from elsewhere (each scheme's
    # params_from_numpy, e.g. lsh.e2lsh.params_from_numpy) in place of
    # drawing them from `seed`
    params: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(self.mesh, DeviceMesh):
                raise TypeError(f"mesh= takes a DeviceMesh (launch/mesh.py), got "
                                f"{type(self.mesh).__name__}")
            if self.device is None:
                self.device = self.mesh.device_type
        self.device = resolve_device(self.device)
        if self.mesh is not None and self.device.type != self.mesh.device_type:
            raise ValueError(f"the service runs on {self.device} and its mesh on "
                             f"{self.mesh.device_type} devices")
        # full float32 for the LSH projection (see the module docstring)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.m = self.m_override or tau_ann.required_m(self.eps, self.delta)
        if self.max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {self.max_segments}")
        self._scheme = lsh_lib.get_scheme(self.scheme)
        # fail at construction, not at the first add(): WIDE-only engines
        # (e2lsh -> EQ) reject PACKED here
        self.signature_layout = engines_lib.get(
            self._scheme.engine).require_layout(self.signature_layout)
        self._params = None
        self._dim: Optional[int] = None
        if self.params is not None:
            self.load_params(self.params)
        self._index: Optional[SegmentedIndex] = None
        self._items: list = []
        # sharded-serving placement cache: (corpus fingerprint, data, n)
        self._placed: Optional[tuple] = None
        # router cache: (corpus fingerprint, Router) -- invalidated by the
        # same fingerprint that refreshes the sharded placement
        self._routed: Optional[tuple] = None

    def load_params(self, params) -> None:
        """Install scheme parameters made elsewhere in place of drawing them
        from `seed`, so two services hash with identical functions.  Only
        before the first add(): the corpus is hashed with one parameter set."""
        if self._params is not None:
            raise ValueError(
                "the LSH parameters are already fixed (by an earlier "
                "load_params() or the first add()); they are built once per "
                "service")
        # the scheme's own parameter shape; d is None for a scheme whose
        # parameters fix no input dimension (minhash): the first add fixes it
        m, d = params.dims
        if m != self.m:
            raise ValueError(
                f"parameters carry {m} hash functions but the service is "
                f"configured for m={self.m}; pass m_override={m}")
        self._params = params.to(self.device)
        self._dim = d

    def _make_params(self, d: int):
        # drawn on the CPU and moved: one seed, one parameter set, wherever
        # the service runs
        gen = torch.Generator(device="cpu").manual_seed(self.seed)
        return self._scheme.make_params(
            gen, d=d, m=self.m, device=self.device,
            w=self.w, sigma=self.sigma, n_buckets=self.n_buckets,
        )

    def _hash(self, x) -> torch.Tensor:
        x = tensor_from(x).to(device=self.device, dtype=torch.float32)
        return self._scheme.hash_points(self._params, x)

    def _embed(self, items, embeddings, expect_rows=None):
        if embeddings is None:
            if self.embed_fn is None:
                raise ValueError(
                    "no embed_fn was given to the service: pass embeddings=")
            emb = self.embed_fn(items)
        else:
            emb = embeddings
        if not isinstance(emb, torch.Tensor):
            emb = np.asarray(emb)
        if emb.ndim != 2:
            raise ValueError(f"embeddings must be [n, d], got shape {tuple(emb.shape)}")
        if expect_rows is not None and emb.shape[0] != expect_rows:
            raise ValueError(
                f"embeddings row count {emb.shape[0]} != {expect_rows} "
                f"items/queries"
            )
        if self._dim is not None and emb.shape[-1] != self._dim:
            raise ValueError(
                f"embedding dim {emb.shape[-1]} != dim {self._dim} fixed by the "
                f"first add(); the LSH parameters are built once per service"
            )
        return emb

    def add(self, items, embeddings=None) -> None:
        """Add items to the corpus: hashes the batch once and seals it into a
        new index segment (O(batch) device work; earlier segments untouched)."""
        items = list(items)
        if not items:
            raise ValueError("cannot add an empty batch of items")
        emb = self._embed(items, embeddings, expect_rows=len(items))
        if self._dim is None:
            self._dim = int(emb.shape[-1])
        if self._params is None:
            self._params = self._make_params(self._dim)
        if self._index is None:
            self._index = SegmentedIndex(engine=self._scheme.engine,
                                         max_count=self.m,
                                         use_kernel=self.use_kernel,
                                         signature_layout=self.signature_layout,
                                         device=self.device)
        self._index.add(self._hash(emb))
        self._items.extend(items)
        if len(self._index.segments) > self.max_segments:
            self._index.compact(max(1, self.max_segments // 2))

    def __len__(self) -> int:
        return len(self._items)

    @property
    def index_stats(self):
        """Aggregate IndexStats with per-segment build/compaction accounting."""
        if self._index is None:
            raise ValueError(
                "RetrievalService index is empty (no items added yet): "
                "call add() before reading index_stats"
            )
        return self._index.stats

    def _corpus_fingerprint(self) -> tuple:
        idx = self._index
        return (len(idx.segments), idx.n_objects, idx.compaction_count)

    def _sharded_corpus(self) -> tuple:
        """(sharded data, n_objects), cached until the corpus changes."""
        from torch.distributed.tensor import distribute_tensor

        fp = self._corpus_fingerprint()
        if self._placed is None or self._placed[0] != fp:
            self._placed = None                # the old placement goes first
            data, n = self._index.concat_data(pad_multiple=self.mesh.size())
            # every rank holds the same corpus: each takes its own rows
            data = distribute_tensor(data, self.mesh, distributed.data_sharding(self.mesh),
                                     src_data_rank=None)
            self._placed = (fp, data, n)
        return self._placed[1], self._placed[2]

    def _router(self) -> routing_lib.Router:
        """Router over the current segments' summaries, cached until the
        corpus changes (same fingerprint as the sharded placement)."""
        fp = self._corpus_fingerprint()
        if self._routed is None or self._routed[0] != fp:
            self._routed = (fp, self._index.router())
        return self._routed[1]

    def resolve_queries(self, queries, embeddings=None):
        """Materialise and embed one query batch, validating it eagerly:
        iterators are listed before len(), row counts and dims are checked,
        and an empty batch raises a ValueError naming the contract (the
        mirror of the empty-`add()` check) instead of failing downstream
        with a shape error."""
        if queries is not None:
            # materialise iterators/generators before len() -- same contract
            # as add(items); embed_fn receives the list either way
            queries = list(queries)
        eshape = None if embeddings is None else tuple(np.shape(embeddings))
        empty = (len(queries) == 0 if queries is not None
                 else bool(eshape) and eshape[0] == 0)
        if empty:
            # checked before embed_fn/shape validation so the caller sees
            # the contract, not a downstream shape error
            raise ValueError(
                "cannot search an empty batch of queries (the mirror of the "
                "empty-add() contract): pass at least one query or embedding "
                "row"
            )
        return self._embed(queries, embeddings,
                           expect_rows=None if queries is None else len(queries))

    def batch_compat_key(self, k: int, method: TopKMethod,
                         routing: routing_lib.Routing | str, *,
                         nprobe: Optional[int] = None,
                         candidate_cap: Optional[int] = None) -> tuple:
        """The coalescing key of a search against this service (core/plan.py
        `batch_compat_key`): two submissions with equal keys can stack into
        one device dispatch.  The layout axis is resolved the way `search`
        will execute -- DISTRIBUTED on a mesh-backed service, SEGMENTED
        otherwise."""
        layout = (plan_lib.Layout.DISTRIBUTED if self.mesh is not None
                  else plan_lib.Layout.SEGMENTED)
        return plan_lib.batch_compat_key(
            self._scheme.engine, layout, self.signature_layout, routing,
            method, k, nprobe=nprobe, candidate_cap=candidate_cap)

    def search(self, queries, k: int = 10, *, embeddings=None,
               method: TopKMethod = TopKMethod.CPQ,
               candidate_cap: Optional[int] = None,
               routing: routing_lib.Routing | str = routing_lib.Routing.NONE,
               nprobe: Optional[int] = None):
        """tau-ANN retrieval over the sealed corpus: (TopKResult of tensors
        on the service's device, similarity estimates as a numpy array).

        `routing` plugs the coarse router (core/routing.py) in front of the
        exact match: 'routed' scans only the segments the router selects
        (approximate), 'routed_verified' also verifies the result threshold
        against the skipped segments' upper bounds and falls back to the
        full scan when one could still contribute (results then equal
        'none' bit for bit)."""
        if self._index is None:
            # a real exception, not an assert: asserts vanish under python -O
            raise ValueError(
                "RetrievalService index is empty (no items added yet): "
                "call add() before search()"
            )
        with trace.span("search", k=k):
            return self._search(queries, k, embeddings, method, candidate_cap, routing, nprobe)

    def _search(self, queries, k, embeddings, method, candidate_cap, routing, nprobe):
        """`search` inside its span."""
        routing = routing_lib.Routing(routing)
        emb = self.resolve_queries(queries, embeddings)
        with trace.span("hash"):
            qsigs = self._hash(emb)
        # the cached router rides into the search, so interleaved add /
        # search rebuild routing state only when the corpus changed
        router = self._router() if routing is not routing_lib.Routing.NONE else None
        if self.mesh is None:
            res = self._index.search(qsigs, k=k, method=method,
                                     candidate_cap=candidate_cap, routing=routing,
                                     nprobe=nprobe, router=router,
                                     autotune=self._autotune_cache())
        else:
            # sharded serving: the segmented corpus planned across the mesh
            # via the DISTRIBUTED layout, served by the same executor --
            # results are identical to the single-device segment merge
            data, n = self._sharded_corpus()
            plan = plan_lib.plan_search(
                self._scheme.engine, k, self._index.max_count,
                layout=plan_lib.Layout.DISTRIBUTED, n_objects=n, method=method,
                candidate_cap=candidate_cap,
                use_kernel=self._index.use_kernel,
                mesh_axes=plan_lib._mesh_axes(self.mesh),
                signature_layout=self.signature_layout,
                routing=routing, nprobe=nprobe,
                autotune=self._autotune_cache(),
                tune_width=int(data.shape[1]),
            )
            model = engines_lib.get(self._scheme.engine)
            # the router scores canonical WIDE queries; the executor gets
            # them packed when the corpus is PACKED.  Every rank holds the
            # same queries: they are replicated as they stand.
            q_wide = model.prepare_queries(qsigs, self.device)
            canonical = q_wide
            if SignatureLayout(self.signature_layout) is SignatureLayout.PACKED:
                canonical = model.pack_queries(q_wide)
            res = plan_lib.execute(plan, data, canonical, mesh=self.mesh,
                                   router=router, route_queries=q_wide)
        # scheme-paired MLE: c/m for bucketed families (Eqn 7), the simhash
        # angle inversion for COSINE
        with trace.span("mle"):
            sims = self._scheme.mle(res.counts.cpu().numpy(), self.m)
        return res, sims

    def _autotune_cache(self):
        """The service's autotune spec resolved against its device (None
        when off)."""
        from repro_torch.core import autotune as autotune_lib

        return autotune_lib.resolve_cache(self.autotune, self.device)

    def tune(self, queries, k: int = 10, *, embeddings=None,
             method: TopKMethod = TopKMethod.CPQ,
             routing: routing_lib.Routing | str = routing_lib.Routing.NONE,
             budget: int = 32, repeats: int = 3,
             cache=None, save: bool = True):
        """Autotune this service's serving shape against a representative
        query batch (core/autotune.py) and return the winning TunedEntry.

        Measures the part-structured search that `search` runs -- block
        shapes, fused preference, candidate_cap, SEGMENTED vs MULTILOAD host
        loop, and (when `routing` is routed) nprobe.  The winner lands in
        `cache` (defaulting to this service's `autotune` spec; an in-memory
        cache on the service's device is created and installed when neither
        is set), so every later `search` picks the tuned knobs up.
        """
        from repro_torch.core import autotune as autotune_lib

        if self._index is None:
            raise ValueError(
                "RetrievalService index is empty (no items added yet): "
                "call add() before tune()"
            )
        routing = routing_lib.Routing(routing)
        emb = self.resolve_queries(queries, embeddings)
        qsigs = self._hash(emb)
        model = engines_lib.get(self._scheme.engine)
        q_wide = model.prepare_queries(qsigs, self.device)
        q_exec = q_wide
        if SignatureLayout(self.signature_layout) is SignatureLayout.PACKED:
            q_exec = model.pack_queries(q_wide)
        stored = torch.cat([s.data for s in self._index.segments], dim=0)
        resolved = autotune_lib.resolve_cache(
            cache if cache is not None else self.autotune, self.device)
        if resolved is None:
            resolved = autotune_lib.AutotuneCache(device=self.device)
        entry = autotune_lib.tune(
            model, stored, q_exec, k, self._index.max_count,
            signature_layout=self.signature_layout, method=method,
            part_rows=tuple(self._index.segment_rows),
            router=(self._router()
                    if routing is not routing_lib.Routing.NONE else None),
            routing=routing, budget=budget, repeats=repeats,
            cache=resolved, save=save, prepared=True, route_queries=q_wide,
        )
        del stored
        if self.autotune is None or self.autotune is False:
            self.autotune = resolved
        return entry

    def items_for(self, result_ids) -> list:
        """Resolve result ids to the stored items; -1 (empty top-k slots)
        resolve to None.  Ids outside [0, len(self)) raise a ValueError
        naming the offender instead of surfacing an IndexError (or, worse,
        a silently wrong negatively-indexed item)."""
        n = len(self._items)
        if isinstance(result_ids, torch.Tensor):
            result_ids = result_ids.cpu().numpy()
        rows = np.asarray(result_ids)
        bad = rows[(rows >= n) | (rows < -1)]
        if bad.size:
            # "0..-1" is not a range: name the empty corpus explicitly
            valid = f"valid ids are 0..{n - 1}" if n else "no ids are valid"
            raise ValueError(
                f"items_for: id {int(bad.flat[0])} is outside the corpus "
                f"({n} items indexed; {valid}, or -1 for an empty top-k slot)"
            )
        return [[self._items[int(i)] if i >= 0 else None for i in row] for row in rows]
