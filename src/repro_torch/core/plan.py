"""Unified query planning + execution: one plan -> execute pipeline for every
GENIE search path.

  * `plan_search(...)` is the single entry point that describes a search as a
    `QueryPlan`: the engine, the part layout, the pad policy, the per-part k
    clamp, and the merge strategy.
  * `execute(plan, data, queries)` is the ONLY code in the system that calls
    match kernels, pad masking, `select_topk`, and the `core/merge` buffers.
    Every index and serving entry point is a thin adapter that builds a plan
    and delegates here.

The four layouts and their merge strategies:

  MONOLITHIC   one device-resident part; selection IS the merge.
  SEGMENTED    host loop over immutable per-segment parts (heterogeneous
               rows); per-part buffers of width min(k, rows) merged exactly
               by `merge_ragged` (parts partition the object set).
  MULTILOAD    paper section III-D part streaming: either a stacked
               [C, Nc, ...] tensor walked chunk by chunk with an incremental
               pairwise merge (`host_loop=False`, the scanned form), or the
               literal host loop (`host_loop=True`): parts held in host
               memory are copied to the queries' device one at a time --
               from pinned memory on a side stream into two reused device
               buffers, so that part i + 1 is in flight while part i is
               matched -- and merged like SEGMENTED parts.
  DISTRIBUTED  object shards across a `DeviceMesh` (torch.distributed, one
               process per rank); each rank matches its own rows and the
               per-shard buffers are all-gathered and merged collectively
               (`hierarchical=True` on a mesh whose first axis is "pod":
               within the pod first, then across pods).

PACKED signatures are planned like WIDE ones; on the kernel path of
MONOLITHIC and SEGMENTED with nothing padded, a PACKED plan carries the
engine's fused match->count->local-top-k kernel (`fused_match`), which
replaces the count matrix, the pad mask and `select_topk` (and so ignores
`method` and `candidate_cap`, as the reference does).  MULTILOAD and
DISTRIBUTED plans never carry it, as in the reference: their data may hold
engine-fill pad rows, so they run the count kernel and the pad mask.

Coarse routing (core/routing.py) applies to the host-loop layouts, SEGMENTED
and MULTILOAD with `host_loop=True`, and to DISTRIBUTED: ROUTED plans match
only the parts a `Router` selects, and ROUTED_VERIFIED plans fall back to
the full scan when a skipped part's upper bound reaches the routed
threshold.  A skipped part is never matched, and in the host loop never
copied to the card; a DISTRIBUTED shard that no routed segment overlaps
blanks its buffer before the gather (every rank still matches, as every
shard does under the reference's shard_map).  The router runs on the host,
on the route queries copied there once a search.

One difference from the reference, in `describe()["fused_hist"]`: the JAX
package keeps the plain histogram on its MULTILOAD and DISTRIBUTED layouts
(`fused_hist = False`: its TPU scan and shard_map bodies kept the jnp
histogram), while the port runs the histogram kernel on every kernel-path
layout, because the port's plain histogram takes ~495 ms a SIFT segment on
the card.  The histogram is exact, so results are the same bit for bit.

Tile knobs and the autotuner: `plan_search(tile_overrides=)` binds kernel
tile sizes onto the kernel path (`QueryPlan.tile_overrides`, which the
kernel wrappers map onto the block shapes they were compiled in), and
`autotune=` / `tune_width=` consult the measured-knob cache of
core/autotune.py, as in the reference.

The DISTRIBUTED layout maps the reference's single-controller program
onto SPMD ranks: its `Mesh` is a `DeviceMesh` (launch/mesh.py), its sharded
array a DTensor with `Shard(0)` on every mesh dimension (or the whole data,
held by every rank, of which each takes its row block), the `shard_map`
body each rank's own `_part_topk` on its local rows, and `all_gather` over
mesh axes `torch.distributed.all_gather` over the groups of those axes,
stacked in the shard order of the reference.  `execute` unwraps a DTensor
once and runs on plain tensors; the result is the same on every rank.

PyTorch runs eagerly, so there is no compiled executable to cache: the JAX
package's `_EXEC_CACHE`, `trace_count`, `plan_cache_size` and
`clear_plan_cache` count jit traces, and have no counterpart here.  That is
a difference by design, not a missing part: what they checked in the
reference -- a warm search compiles nothing new -- is checked in the port on
the kernel build cache (`kernels/build.py`, one build per source state) and
on the launch counts per kernel (`kernels/common.py`).  A QueryPlan is still
hashable and still the key two requests must share to be batched together
(`batch_compat_key`).

Invariants owned here: pad-never-in-topk (counts of rows with global id >=
n_objects are forced to -1 *before* selection), the (count desc, id asc)
tie-break (stable buffer merges over id-ascending parts), and the ragged
per-part k clamp.
"""
from __future__ import annotations

import dataclasses
import enum
import weakref
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import cpq as _cpq
from repro_torch.core import engines as _engines
from repro_torch.core import merge as _merge
from repro_torch.core import routing as _routing
from repro_torch.core.routing import Routing
from repro_torch.core.select import select_topk
from repro_torch.core.types import (Engine, SearchParams, SignatureLayout,
                                    TopKMethod, TopKResult)

MatchLike = Union[Engine, str, "_engines.MatchModel",
                  Callable[[torch.Tensor, Any], torch.Tensor]]


class Layout(str, enum.Enum):
    """Part layout of a planned search."""

    MONOLITHIC = "monolithic"      # one device-resident data matrix
    SEGMENTED = "segmented"        # host loop over sealed per-batch segments
    MULTILOAD = "multiload"        # streamed index parts (scan or host loop)
    DISTRIBUTED = "distributed"    # object shards across a device mesh


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A fully-resolved description of one search: who matches, over which
    parts, how pads are masked, how much each part contributes to the merge.

    Hashable by construction.
    """

    match: Callable[[torch.Tensor, Any], torch.Tensor]  # canonical match fn
    params: SearchParams
    layout: Layout
    part_rows: tuple[int, ...] = ()    # physical rows per part
    n_objects: Optional[int] = None    # real corpus rows; None = nothing padded
    engine: Optional[Engine] = None    # None when `match` is a raw callable
    pad_value: Any = None              # engine fill for padded rows
    host_loop: bool = False            # MULTILOAD: host streaming vs scanned stack
    hierarchical: bool = False         # DISTRIBUTED: pod-local merge first
    mesh_axes: tuple[str, ...] = ()    # DISTRIBUTED: mesh axis names
    # signature storage format the match fn expects
    signature_layout: SignatureLayout = SignatureLayout.WIDE
    # fused match->count->local-top-k kernel fn(data, queries, k) ->
    # (ids, counts) candidate buffers; None => count matrix + select_topk
    fused_match: Optional[Callable[[torch.Tensor, Any, int], tuple]] = None
    # coarse routing mode (core/routing.py): NONE scans every part; ROUTED /
    # ROUTED_VERIFIED prune through a Router built from segment summaries
    routing: Routing = Routing.NONE
    # probe width for ROUTED/ROUTED_VERIFIED; None = Router's sqrt(S) default
    nprobe: Optional[int] = None
    # tuned kernel tile sizes as canonical sorted ((knob, value), ...) pairs
    # (core/autotune.py; engines.canonical_tile_overrides).  Part of the plan's
    # equality and hash, and the memoised tile-bound match callables keep
    # equal plans equal.
    tile_overrides: tuple = ()

    # -- derived layout facts ----------------------------------------------
    @property
    def n_parts(self) -> int:
        return len(self.part_rows)

    @property
    def total_rows(self) -> int:
        return sum(self.part_rows)

    @property
    def pad_rows(self) -> int:
        if self.n_objects is None or not self.part_rows:
            return 0
        return self.total_rows - self.n_objects

    def part_k(self, rows: int) -> int:
        """Ragged k clamp: a part smaller than k contributes only
        min(k, rows) candidates (host-loop layouts)."""
        return min(self.params.k, rows)

    def merge_strategy(self) -> str:
        if self.layout == Layout.MONOLITHIC:
            return "none"
        if self.layout == Layout.DISTRIBUTED:
            return "collective-hierarchical" if self.hierarchical else "collective"
        if self.layout == Layout.MULTILOAD and not self.host_loop:
            return "incremental-pairwise"
        return "ragged-buffer"

    def describe(self) -> dict:
        """Host-side plan summary, with the keys and values of the JAX
        package's `QueryPlan.describe()` (but `fused_hist`: the module
        docstring says why)."""
        rows = list(self.part_rows)
        # both per-part lists truncate identically: a "..." marker past 32
        # parts, never a silent cut (the lists must stay row-aligned)
        truncated = len(rows) > 32
        part_k = [self.part_k(r) for r in rows[:32]]
        return dict(
            layout=self.layout.value,
            engine=self.engine.value if self.engine else "<callable>",
            k=self.params.k,
            method=self.params.method.value,
            use_kernel=self.params.use_kernel,
            n_parts=self.n_parts,
            part_rows=rows[:32] + ["..."] if truncated else rows,
            part_k=part_k + ["..."] if truncated else part_k,
            n_objects=self.n_objects,
            pad_rows=self.pad_rows,
            merge=self.merge_strategy(),
            host_loop=self.host_loop,
            hierarchical=self.hierarchical,
            mesh_axes=list(self.mesh_axes),
            fused_hist=self.params.use_kernel,
            signature_layout=self.signature_layout.value,
            fused_match=self.fused_match is not None,
            routing=self.routing.value,
            nprobe=self.nprobe,
            tile_overrides=dict(self.tile_overrides),
        )


def plan_search(
    engine: MatchLike,
    k: int,
    max_count: int,
    *,
    layout: Layout = Layout.MONOLITHIC,
    part_rows: Optional[Sequence[int]] = None,
    n_parts: Optional[int] = None,
    n_objects: Optional[int] = None,
    method: TopKMethod = TopKMethod.CPQ,
    candidate_cap: Optional[int] = None,
    use_kernel: bool = True,
    host_loop: bool = False,
    hierarchical: bool = False,
    mesh_axes: Sequence[str] = (),
    signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
    routing: Routing | str = Routing.NONE,
    nprobe: Optional[int] = None,
    tile_overrides: Optional[Any] = None,
    autotune: Optional[Any] = None,
    tune_width: Optional[int] = None,
) -> QueryPlan:
    """The single planning entry point: resolve the engine, lay out the
    parts, fix the pad policy and merge strategy, return the QueryPlan.

    `engine` may be an Engine, its string value, a MatchModel, or a raw
    canonical callable ``fn(data, queries) -> counts``.

    Layout shape: pass `part_rows` (explicit, possibly ragged part sizes) or
    `n_parts` with `n_objects` (an even split padded up to divisibility --
    the classic multiload partition).  `n_objects` is the count of real rows
    when the data carries engine-fill pad rows past it; those can then never
    reach a result.  A MULTILOAD plan streams host parts with
    `host_loop=True` (ragged parts allowed) or walks a stacked [C, Nc, ...]
    tensor (uniform parts).  DISTRIBUTED plans take their shape from the data
    that arrives (each rank matches its own rows); `hierarchical` merges
    pod-locally first when the mesh's first axis is "pod", and `mesh_axes`
    records the mesh's axis names.

    `signature_layout` selects the storage format the data/queries arrive in
    (core/packing.py): PACKED plans dispatch the packed match fns and -- on
    the kernel path with nothing padded -- the fused
    match->count->local-top-k kernel, so the [Q, N] count matrix is never
    written.  Engines without a packed format reject PACKED here.  A
    measured autotune entry may switch the fusion off (`fused_match=False`).

    `routing` plans coarse segment pruning (core/routing.py): ROUTED and
    ROUTED_VERIFIED plans execute against a Router built from segment
    summaries (`execute(..., router=...)`) and skip the parts the router
    rules out.  Routing prunes host-streamed parts or mesh shards, so it
    requires SEGMENTED, MULTILOAD with host_loop=True, or DISTRIBUTED;
    MONOLITHIC and scanned MULTILOAD are one pass with nothing to skip and
    reject it here.  `nprobe` (>= 1) is kept on routed plans only.

    `tile_overrides` binds kernel tile sizes (tile_q / tile_n / tile_v /
    tile_m, the knobs kernels/ops.py accepts) onto the kernel dispatch path;
    it is rejected for use_kernel=False plans and raw callables.  `autotune`
    consults a measured-knob cache (core/autotune.py: True for the default
    cache, a path, or an AutotuneCache) and fills tile_overrides /
    candidate_cap / nprobe / fused-match preference for whatever the caller
    left unset -- explicit arguments always win, and a cache miss (including
    a hardware-fingerprint mismatch) keeps the defaults.  A path or True is
    resolved against the card (the device rule: `device=None`); the index
    and service entry points resolve it against their own device first.
    `tune_width` is the physical signature width hint for the cache's
    bucketing.
    """
    sig_layout = SignatureLayout(signature_layout)
    model: Optional[_engines.MatchModel] = None
    match: Any = None
    if callable(engine) and not isinstance(engine, (_engines.MatchModel, Engine, str)):
        # raw callables own the layout contract; the plan just records it
        match = engine
    else:
        model = _engines.get(engine)
        sig_layout = model.require_layout(sig_layout)

    tiles = _engines.canonical_tile_overrides(tile_overrides)
    tuned_fused: Optional[bool] = None
    if autotune is not None and autotune is not False and model is not None:
        # lazy import: the autotuner times candidate plans through this very
        # module, so a top-level import would be circular
        from repro_torch.core import autotune as _autotune

        n_hint = n_objects
        if n_hint is None and part_rows is not None:
            n_hint = sum(int(r) for r in part_rows)
        entry = _autotune.consult(
            autotune, engine=model.engine, signature_layout=sig_layout,
            n=n_hint, width=tune_width,
        )
        if entry is not None:
            # tuned knobs fill only what the caller left unset: explicit
            # arguments always win over the cache.  Tile sizes and the fused
            # preference are kernel-path knobs; candidate_cap and nprobe
            # shape selection on every dispatch path.
            if use_kernel:
                if not tiles and entry.tile_overrides:
                    tiles = _engines.canonical_tile_overrides(entry.tile_overrides)
                tuned_fused = entry.fused_match
            if candidate_cap is None and entry.candidate_cap is not None:
                candidate_cap = int(entry.candidate_cap)
            if (nprobe is None and entry.nprobe is not None
                    and Routing(routing) is not Routing.NONE):
                nprobe = int(entry.nprobe)
    if tiles:
        if model is None:
            raise ValueError(
                "tile_overrides require a registered engine; a raw match "
                "callable owns its own tiling"
            )
        if not use_kernel:
            raise ValueError(
                "tile_overrides only apply to kernel dispatch; "
                "use_kernel=False plans take none"
            )
    if model is not None:
        match = model.match_fn(use_kernel, sig_layout, tiles)

    layout = Layout(layout)
    if part_rows is None and n_parts is not None:
        if n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        if n_objects is None:
            raise ValueError("an even multiload split needs n_objects")
        per = -(-n_objects // n_parts)
        part_rows = (per,) * n_parts
    rows = tuple(int(r) for r in part_rows) if part_rows is not None else ()
    if layout in (Layout.SEGMENTED, Layout.MULTILOAD) and not rows:
        raise ValueError(f"{layout.value} layout requires part_rows (or n_parts)")
    if layout == Layout.MONOLITHIC and len(rows) > 1:
        raise ValueError(f"monolithic layout got {len(rows)} parts")
    if any(r < 1 for r in rows):
        raise ValueError(f"part_rows must be positive, got {rows}")
    if layout == Layout.MULTILOAD and not host_loop and len(set(rows)) > 1:
        # the scanned executor derives global-id offsets as i * part_rows[0];
        # ragged parts would globalise wrong ids
        raise ValueError(
            f"scanned multiload layout requires uniform part_rows, got {rows}; "
            f"pass host_loop=True to stream ragged parts"
        )

    routing = Routing(routing)
    host_looped = bool(host_loop) and layout == Layout.MULTILOAD
    if routing is not Routing.NONE:
        routable = (layout == Layout.SEGMENTED or host_looped
                    or layout == Layout.DISTRIBUTED)
        if not routable:
            raise ValueError(
                f"routing={routing.value!r} prunes host-streamed parts or "
                f"mesh shards; a {layout.value} plan"
                f"{'' if host_loop or layout != Layout.MULTILOAD else ' (scanned)'}"
                f" is one device program with nothing to skip -- use "
                f"routing='none', or a SEGMENTED / MULTILOAD host_loop / "
                f"DISTRIBUTED layout"
            )
        if nprobe is not None and int(nprobe) < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        nprobe = None if nprobe is None else int(nprobe)
    else:
        nprobe = None  # full-scan plans stay equal whatever nprobe was passed
    params = SearchParams(k=k, max_count=max_count, method=method,
                          candidate_cap=candidate_cap, use_kernel=use_kernel)
    # The fused match->count->local-top-k kernel replaces the whole
    # count+select pipeline.  Single-device MONOLITHIC / SEGMENTED only, plus
    # n_objects None: the kernel masks rows by *physical* row id, so
    # engine-filled pad rows (multiload stacks, mesh divisibility) must not be
    # present -- those layouts keep the packed count kernel + the structural
    # _mask_pad_counts.
    fused_topk = None
    if (model is not None and sig_layout is SignatureLayout.PACKED
            and use_kernel and n_objects is None
            and layout in (Layout.MONOLITHIC, Layout.SEGMENTED)
            and tuned_fused is not False):
        fused_topk = model.fused_topk_fn(tiles)
    return QueryPlan(
        match=match, params=params, layout=layout, part_rows=rows,
        n_objects=n_objects, engine=model.engine if model else None,
        pad_value=model.pad_value_for(sig_layout) if model else None,
        host_loop=host_looped, hierarchical=bool(hierarchical), mesh_axes=tuple(mesh_axes),
        signature_layout=sig_layout, fused_match=fused_topk, routing=routing,
        nprobe=nprobe, tile_overrides=tiles,
    )


# ---------------------------------------------------------------------------
# Batch compatibility (the serving front-end's coalescing key)
# ---------------------------------------------------------------------------

def k_bucket(k: int) -> int:
    """Round k up to the next power of two (floor 1).

    A serving front-end coalesces concurrent requests into one device
    dispatch; bucketing k means requests for k=5 and k=8 share the k=8
    search.  Truncating a top-8 result to a request's own k is bit-for-bit
    identical to searching at that k: the (count desc, id asc) order is
    total, so a top-k result is a prefix of any larger top-k' result."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return 1 << (int(k) - 1).bit_length()


def batch_compat_key(
    engine: Engine | str,
    layout: Layout | str,
    signature_layout: SignatureLayout | str,
    routing: Routing | str,
    method: TopKMethod | str,
    k: int,
    *,
    nprobe: Optional[int] = None,
    candidate_cap: Optional[int] = None,
) -> tuple:
    """The coalescing key of one serving request: two requests with equal
    keys can share a single planned dispatch (stacked queries) and still
    scatter bit-for-bit per-request results.

    The axes are engine x layout x signature_layout x routing x method x
    k-bucket, plus the two knobs that change a plan's selection behaviour
    (nprobe, candidate_cap).  An explicit candidate_cap disables
    k-bucketing: the effective buffer capacity is max(cap, k), so bucketing k
    would silently change the cap the caller pinned."""
    kb = int(k) if candidate_cap is not None else k_bucket(k)
    return (
        Engine(engine) if not isinstance(engine, Engine) else engine,
        Layout(layout),
        SignatureLayout(signature_layout),
        Routing(routing),
        TopKMethod(method),
        kb,
        nprobe,
        candidate_cap,
    )


# ---------------------------------------------------------------------------
# Pad policy (the only pad masking / pad filling in the system)
# ---------------------------------------------------------------------------

def _mask_pad_counts(counts: torch.Tensor, offset: int, n_objects: Optional[int]) -> torch.Tensor:
    """Force pad columns (global id >= n_objects) to count -1 *before*
    selection, so pad rows can never crowd real candidates out of a candidate
    buffer.  This makes pad safety structural for every engine: the
    `pad_value` fill only has to be representable, not score-neutral."""
    if n_objects is None:
        return counts
    gcol = offset + torch.arange(counts.shape[-1], dtype=torch.int32, device=counts.device)
    return torch.where((gcol < n_objects)[None, :], counts, -1)


def _mask_invalid(gids: torch.Tensor, counts: torch.Tensor, n_objects: Optional[int]):
    """Drop padding rows post-selection: ids at/above the true object count
    never merge (belt to `_mask_pad_counts`'s braces)."""
    valid = gids >= 0
    if n_objects is not None:
        valid &= gids < n_objects
    return torch.where(valid, gids, -1), torch.where(valid, counts, -1)


def pad_to_multiple(data: torch.Tensor, multiple: int, pad_value) -> tuple[torch.Tensor, int]:
    """(padded data, true row count): append engine-fill rows up to the next
    multiple (shard divisibility, even part splits)."""
    n = int(data.shape[0])
    pad = (-n) % max(int(multiple), 1)
    if pad:
        fill = torch.full((pad,) + tuple(data.shape[1:]), pad_value,
                          dtype=data.dtype, device=data.device)
        data = torch.cat([data, fill], dim=0)
    return data, n


def pad_and_stack(plan: QueryPlan, data: torch.Tensor) -> torch.Tensor:
    """Materialise a MULTILOAD scan layout from a monolithic data matrix:
    pad with the plan's engine fill and stack into [C, Nc, ...] chunks (a
    view of `data` when nothing is padded)."""
    if plan.layout != Layout.MULTILOAD or not plan.part_rows:
        raise ValueError(f"pad_and_stack needs a MULTILOAD plan, got {plan.layout}")
    if plan.pad_value is None:
        raise ValueError("pad_and_stack needs an engine-resolved plan "
                         "(raw-callable plans carry no pad fill)")
    per = plan.part_rows[0]
    want = per * plan.n_parts
    n = int(data.shape[0])
    if n > want:
        raise ValueError(f"data has {n} rows but the plan lays out {want}")
    if n < want:
        fill = torch.full((want - n,) + tuple(data.shape[1:]), plan.pad_value,
                          dtype=data.dtype, device=data.device)
        data = torch.cat([data, fill], dim=0)
    return data.reshape(plan.n_parts, per, *data.shape[1:])


# ---------------------------------------------------------------------------
# Executors: the ONLY callers of match kernels, pad masks, select, and merge
# ---------------------------------------------------------------------------

def _fused_candidates_topk(fused_match, data: torch.Tensor, queries: Any,
                           k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Run a fused match->count->local-top-k kernel and reduce its per-tile
    candidate buffers to the final (ids, counts) [Q, k].

    Per-tile buffers arrive in (count desc, id asc) order with tiles in
    ascending id ranges, so the buffer as a whole is id-ascending within
    equal counts -- exactly what topk_from_candidates' stable merge needs
    for the global tie-break."""
    with trace.span("fused_topk"):
        cids, ccnt = fused_match(data, queries, k)
        if cids.shape[1] < k:  # tiny corpus: fewer candidate slots than k
            fill = cids.new_full((cids.shape[0], k - cids.shape[1]), -1)
            cids = torch.cat([cids, fill], dim=1)
            ccnt = torch.cat([ccnt, fill], dim=1)
        # genielint: ignore[executor-sovereignty] -- the port's own executor
        return _cpq.topk_from_candidates(cids, ccnt, k)


def _match_masked(plan: QueryPlan, data: torch.Tensor, queries: Any,
                  offset: int) -> torch.Tensor:
    """One part's counts [Q, rows], pad columns forced to -1."""
    with trace.span("match"):
        counts = plan.match(data, queries)
    with trace.span("pad_mask"):
        # genielint: ignore[executor-sovereignty] -- the port's own executor
        return _mask_pad_counts(counts, offset, plan.n_objects)


def _part_span(index: int, rows: int, queries: Any, k: int):
    """The span of one part of a search: its rows, the query rows, and the
    width of its buffer."""
    return trace.span("part", index=index, rows=rows,
                      queries=int(_first_query_tensor(queries).shape[0]), k=k)


def _part_topk(plan: QueryPlan, data: torch.Tensor, queries: Any, offset: int,
               k: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One part's candidate buffer: match -> pad mask -> select -> globalise
    (or the fused kernel in place of the first three).

    The shared core of every layout.  Returns (global ids, counts), both
    [Q, k], empty slots -1."""
    if plan.fused_match is not None:
        # fused plans are never masked (plan_search gates on n_objects None):
        # the kernel's own physical-row masking is exhaustive
        ids, cnts = _fused_candidates_topk(plan.fused_match, data, queries,
                                           plan.params.k if k is None else k)
        return torch.where(ids >= 0, ids + offset, -1), cnts
    params = plan.params if k is None or k == plan.params.k \
        else dataclasses.replace(plan.params, k=k)
    counts = _match_masked(plan, data, queries, offset)
    # genielint: ignore[executor-sovereignty] -- the port's own executor
    local = select_topk(counts, params)
    del counts
    gids = torch.where(local.ids >= 0, local.ids + offset, -1)
    # genielint: ignore[executor-sovereignty] -- the port's own executor
    return _mask_invalid(gids, local.counts, plan.n_objects)


def _run_monolithic(plan: QueryPlan, data: torch.Tensor, queries: Any) -> TopKResult:
    k = plan.params.k
    with _part_span(0, int(data.shape[0]), queries, k):
        if plan.fused_match is not None:
            ids, counts = _fused_candidates_topk(plan.fused_match, data, queries, k)
            return TopKResult(ids=ids, counts=counts, threshold=counts[:, -1])
        counts = _match_masked(plan, data, queries, 0)
        # selection is the merge: return select_topk's result (threshold
        # included) as it stands
        # genielint: ignore[executor-sovereignty] -- the port's own executor
        return select_topk(counts, plan.params)


def _first_query_tensor(queries: Any) -> torch.Tensor:
    """The query tensor, or the first of a tuple (RANGE's (lo, hi)): its rows
    are the queries, its device is where every part is matched."""
    return queries[0] if isinstance(queries, (tuple, list)) else queries


def _run_scan(plan: QueryPlan, chunks: torch.Tensor, queries: Any) -> TopKResult:
    """The scanned MULTILOAD form: the [C, Nc, ...] chunks of a stacked
    tensor one after another, each selected at the full k and merged into
    the running best by `topk_from_candidates` over [best, part] -- the
    reference's lax.scan step, whose tie order (best first, then the part's
    id-ascending buffer) it keeps."""
    if chunks.dim() < 2 or int(chunks.shape[0]) != plan.n_parts \
            or int(chunks.shape[1]) != plan.part_rows[0]:
        raise ValueError(f"plan lays out {plan.n_parts} chunks of {plan.part_rows[0]} rows, "
                         f"got a stack of shape {tuple(chunks.shape)}")
    k, nc = plan.params.k, plan.part_rows[0]
    first = _first_query_tensor(queries)
    best_ids = torch.full((first.shape[0], k), -1, dtype=torch.int32, device=first.device)
    best_counts = torch.full_like(best_ids, -1)
    for i in range(plan.n_parts):
        with _part_span(i, nc, queries, k):
            gids, gcnt = _part_topk(plan, chunks[i], queries, i * nc)
        with trace.span("merge"):
            # genielint: ignore[executor-sovereignty] -- the port's own executor
            best_ids, best_counts = _cpq.topk_from_candidates(
                torch.cat([best_ids, gids[:, :k]], dim=-1),
                torch.cat([best_counts, gcnt[:, :k]], dim=-1), k)
    return TopKResult(ids=best_ids, counts=best_counts, threshold=best_counts[:, -1])


def _host_tensor(part) -> torch.Tensor:
    """A part as a tensor: numpy arrays wrapped (no copy), tensors as they are."""
    return part if isinstance(part, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(part))


# bytes the host loop has copied from host memory to a card (`_device_parts`),
# under the key "bytes"
_COPIED: dict[str, int] = trace.counter("plan.copied_bytes")


def copied_bytes() -> int:
    """Bytes of host parts the host loop copied to a card since the last
    reset (a part it skips, or one already on the card, adds nothing)."""
    return _COPIED.get("bytes", 0)


def reset_copied_bytes() -> None:
    _COPIED.clear()


def _device_parts(parts: Sequence, device: torch.device):
    """Yield the parts on `device`, in order.

    A part already there is yielded as it is; on a CPU device a numpy part
    is wrapped.  A part in host memory bound for a card is copied by a side
    stream into one of two device buffers, sized for the largest part and
    reused, with part i + 1's copy enqueued before part i is yielded: from
    pinned memory the copy runs while part i is matched (from pageable
    memory, or numpy, it still works, without the overlap).  CUDA events
    order the two streams: a buffer is first filled only after all the work
    enqueued on the consumer's stream before its allocation (the allocator
    may hand it memory that work still reads or writes), it is refilled only
    after the work the consumer enqueued on part i - 2 (which used it) has
    run, and part i is matched only after its copy has landed.  A part on
    another card is moved with `.to(device)`.  On a CPU device a part on a
    card raises ValueError: a failed copy or a mismatch raises, and nothing
    moves to the CPU on its own."""
    if device.type != "cuda":
        for part in parts:
            host = _host_tensor(part)
            if host.device != device:
                raise ValueError(f"a part lies on {host.device} and the queries on {device}: "
                                 f"move the queries to the part's device or the part to "
                                 f"host memory")
            yield host
        return
    hosts = [_host_tensor(p) if not (isinstance(p, torch.Tensor) and p.is_cuda) else None
             for p in parts]
    order = [i for i, h in enumerate(hosts) if h is not None]
    current = torch.cuda.current_stream(device)
    copier = torch.cuda.Stream(device)
    rows = max((int(hosts[i].shape[0]) for i in order), default=0)
    slot_of = {i: pos % 2 for pos, i in enumerate(order)}
    bufs: list[Optional[torch.Tensor]] = [None, None]
    ready = [torch.cuda.Event(), torch.cuda.Event()]
    free: list[Optional[torch.cuda.Event]] = [None, None]

    def stage(i: int) -> None:
        host, slot = hosts[i], slot_of[i]
        buf = bufs[slot]
        if buf is None or buf.dtype != host.dtype or buf.shape[1:] != host.shape[1:]:
            # allocated on the consumer's stream, filled on the side stream:
            # the side stream waits for the consumer's earlier work, which may
            # still use this memory, and the allocator keeps the block until
            # the side stream's copies have run
            buf = bufs[slot] = torch.empty((rows,) + tuple(host.shape[1:]), dtype=host.dtype,
                                           device=device)
            copier.wait_stream(current)
            buf.record_stream(copier)
        with torch.cuda.stream(copier):
            if free[slot] is not None:
                copier.wait_event(free[slot])
            buf[:host.shape[0]].copy_(host, non_blocking=True)
            ready[slot].record(copier)
        _COPIED["bytes"] = _COPIED.get("bytes", 0) + host.numel() * host.element_size()

    if order:
        stage(order[0])
    pos = 0
    for i, part in enumerate(parts):
        if hosts[i] is None:
            yield part.to(device)
            continue
        pos += 1
        if pos < len(order):
            stage(order[pos])              # part i + 1 in flight while part i is matched
        slot = slot_of[i]
        current.wait_event(ready[slot])
        yield bufs[slot][:hosts[i].shape[0]]
        free[slot] = torch.cuda.Event()
        free[slot].record(current)


def _scan_host_parts(plan: QueryPlan, parts, queries,
                     part_mask: Optional[np.ndarray] = None) -> TopKResult:
    """One pass of the host loop over the (optionally masked) parts: each
    scanned part is brought to the queries' device (`_device_parts`),
    selected into a buffer of width min(k, rows) with its ids globalised by
    its row offset, and the ragged buffers merge exactly.  A skipped part
    never reaches the device -- it is neither copied nor matched -- and its
    rows still advance the offset, so scanned parts keep their id ranges."""
    offsets = []
    offset = 0
    for part, rows in zip(parts, plan.part_rows):
        if int(part.shape[0]) != rows:
            raise ValueError(f"part has {int(part.shape[0])} rows, plan says {rows}")
        offsets.append(offset)
        offset += rows
    picked = [i for i in range(plan.n_parts) if part_mask is None or part_mask[i]]
    first = _first_query_tensor(queries)
    buf_ids, buf_counts = [], []
    for i, part in zip(picked, _device_parts([parts[i] for i in picked], first.device)):
        rows = plan.part_rows[i]
        k = plan.part_k(rows)
        with _part_span(i, rows, queries, k):
            gids, gcnt = _part_topk(plan, part, queries, offsets[i], k=k)
        buf_ids.append(gids)
        buf_counts.append(gcnt)
    if not buf_ids:  # defensive: a router always selects >= 1 segment
        empty = torch.full((first.shape[0], plan.params.k), -1, dtype=torch.int32,
                           device=first.device)
        return TopKResult(ids=empty, counts=empty, threshold=empty[:, -1])
    with trace.span("merge"):
        # genielint: ignore[executor-sovereignty] -- the port's own executor
        return _merge.merge_ragged(buf_ids, buf_counts, plan.params.k)


def _host_array(x):
    """A tensor (or a tuple of them: RANGE's (lo, hi)) as host numpy."""
    if isinstance(x, (tuple, list)):
        return tuple(_host_array(v) for v in x)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _route(plan: QueryPlan, router: Optional["_routing.Router"],
           queries, route_queries) -> tuple[np.ndarray, np.ndarray]:
    """Resolve the routed plan's (segment mask, upper bounds) on the host.

    `route_queries` are the canonical WIDE queries the summaries were built
    against; they default to the execution queries (right whenever the
    plan's signature_layout is WIDE).  They are copied to the host once."""
    if router is None:
        raise ValueError(
            f"a routing={plan.routing.value!r} plan needs router= (built "
            f"from segment summaries, e.g. SegmentedIndex.router())"
        )
    if plan.layout != Layout.DISTRIBUTED and tuple(router.part_rows) != plan.part_rows:
        raise ValueError(
            f"router summarises parts {tuple(router.part_rows)} but the plan "
            f"lays out {plan.part_rows}; rebuild the router from the current "
            f"segments"
        )
    rq = queries if route_queries is None else route_queries
    return router.select(_host_array(rq), plan.nprobe)


def _skipped_could_contribute(result: TopKResult, ubs: np.ndarray,
                              verify_mask: np.ndarray) -> bool:
    """ROUTED_VERIFIED's fallback predicate: could any unscanned segment
    still place a member in the top-k?  True when a skipped segment's upper
    bound reaches the routed result's k-th count -- `>=`, not `>`, because a
    tied count with a smaller id displaces the k-th slot under the
    (count desc, id asc) order, and because an unfilled slot (threshold -1)
    must always force the fallback (every bound is >= a real count of 0)."""
    if not verify_mask.any():
        return False
    thresholds = _host_array(result.threshold).astype(np.float64)  # [Q]
    return bool((ubs[:, verify_mask] >= thresholds[:, None]).any())


def _run_host_parts(plan: QueryPlan, parts, queries, router=None,
                    route_queries=None) -> TopKResult:
    """The host-loop layouts (SEGMENTED and MULTILOAD host_loop), with coarse
    routing when the plan asks for it: ROUTED scans only the router-selected
    parts; ROUTED_VERIFIED also checks the skipped parts' upper bounds
    against the routed threshold and falls back to the full scan when a
    skipped part could still contribute -- equal to routing=NONE bit for
    bit."""
    if len(parts) != plan.n_parts:
        raise ValueError(f"plan lays out {plan.n_parts} parts, got {len(parts)}")
    if plan.routing is Routing.NONE:
        return _scan_host_parts(plan, parts, queries)
    mask, ubs = _route(plan, router, queries, route_queries)
    routed = _scan_host_parts(plan, parts, queries, part_mask=mask)
    if plan.routing is Routing.ROUTED:
        return routed
    if not _skipped_could_contribute(routed, ubs, ~mask):
        return routed
    return _scan_host_parts(plan, parts, queries)


# ---------------------------------------------------------------------------
# The distributed executor: SPMD ranks over a DeviceMesh
# ---------------------------------------------------------------------------

def _mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _shard_linear_index(mesh) -> int:
    """This rank's linearised shard index over the mesh axes (row-major), the
    position of its row block in the data and of its buffer in a gather."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {torch.distributed.get_rank()} is not on the mesh")
    idx = 0
    for c, size in zip(coord, mesh.shape):
        idx = idx * int(size) + int(c)
    return idx


def _local(x):
    """A DTensor's local tensor (a tuple of them: RANGE's (lo, hi)); a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, (tuple, list)):
        return tuple(_local(v) for v in x)
    return x.to_local() if isinstance(x, DTensor) else x


def _shard_rows(data, mesh, shard: int) -> torch.Tensor:
    """This rank's rows: the local shard of a DTensor placed with `Shard(0)`
    on every mesh dimension (core/distributed.data_sharding), or the row
    block `shard` of a whole tensor that every rank holds.  The rows must
    split evenly, as under the reference's shard_map."""
    from torch.distributed.tensor import DTensor, Shard

    n, n_shards = int(data.shape[0]), mesh.size()
    if n % n_shards:
        raise ValueError(
            f"the data's {n} rows do not split evenly over the mesh's {n_shards} "
            f"shards; pad them (SegmentedIndex.concat_data(pad_multiple=mesh.size()))")
    if isinstance(data, DTensor):
        if tuple(data.placements) != (Shard(0),) * mesh.ndim:
            raise ValueError(f"sharded data must be placed with Shard(0) on every mesh "
                             f"dimension (distributed.data_sharding), got {data.placements}")
        return data.to_local()
    per = n // n_shards
    return data[shard * per:(shard + 1) * per]


class _MergeGroups:
    """The process groups of one mesh's collective merge, each with its
    ranks in shard order: the whole mesh; and, on a mesh whose first axis is
    "pod", this rank's pod (built for every pod at once with
    `new_subgroups_by_enumeration`) and the pod axis through this rank."""

    def __init__(self, mesh):
        dist = torch.distributed
        layout = mesh.mesh
        ranks = layout.flatten().tolist()
        world = dist.get_world_size()
        whole = dist.group.WORLD if sorted(ranks) == list(range(world)) \
            else dist.new_group(sorted(ranks))
        self.flat = (whole, ranks)
        self.pod_local = self.across_pods = None
        if _mesh_axes(mesh)[:1] == ("pod",):
            coord = mesh.get_coordinate()
            pods = [layout[p].flatten().tolist() for p in range(layout.shape[0])]
            mine, _ = dist.new_subgroups_by_enumeration(pods)
            self.pod_local = (mine, pods[coord[0]])
            self.across_pods = (mesh.get_group("pod"),
                                layout[(slice(None),) + tuple(coord[1:])].tolist())


# one _MergeGroups per live mesh: groups are made collectively, once
_GROUPS: dict = {}


def _merge_groups(mesh) -> _MergeGroups:
    hit = _GROUPS.get(id(mesh))
    if hit is None or hit[0]() is not mesh:
        hit = _GROUPS[id(mesh)] = (weakref.ref(mesh), _MergeGroups(mesh))
    return hit[1]


def _gather(ids: torch.Tensor, counts: torch.Tensor, group, ranks) -> tuple:
    """All-gather the [Q, k] buffers over `group` into [S, Q, k] stacks in the
    order of `ranks` -- the shard order of the reference's all_gather over
    mesh axes.  (A group lists its members by global rank, which need not be
    that order, and the merge's tie-break is positional.)"""
    pair = torch.stack([ids, counts])
    out = [torch.empty_like(pair) for _ in ranks]
    torch.distributed.all_gather(out, pair, group=group)
    at = {r: i for i, r in enumerate(torch.distributed.get_process_group_ranks(group))}
    stacked = torch.stack([out[at[r]] for r in ranks])
    return stacked[:, 0], stacked[:, 1]


def _collective_merge(plan: QueryPlan, mesh, gids: torch.Tensor,
                      gcnt: torch.Tensor) -> TopKResult:
    """Merge every shard's buffer into the global top-k, the same on every
    rank: one gather over the mesh, or (hierarchical plans on a mesh whose
    first axis is "pod") a merge within the pod, then one across pods."""
    groups = _merge_groups(mesh)
    k = plan.params.k
    if not (plan.hierarchical and groups.pod_local is not None):
        # genielint: ignore[executor-sovereignty] -- the port's own executor
        return _merge.merge_topk(*_gather(gids, gcnt, *groups.flat), k)
    # genielint: ignore[executor-sovereignty] -- the port's own executor
    pod = _merge.merge_topk(*_gather(gids, gcnt, *groups.pod_local), k)
    # genielint: ignore[executor-sovereignty] -- the port's own executor
    return _merge.merge_topk(*_gather(pod.ids, pod.counts, *groups.across_pods), k)


def _run_sharded(plan: QueryPlan, data, queries, mesh,
                 shard_active: Optional[np.ndarray] = None) -> TopKResult:
    """The counterpart of the reference's shard_map body: this rank matches
    its own rows through the shared part kernel, with ids globalised by its
    shard's row offset, then the buffers merge collectively.  Under routing,
    a shard that `shard_active` leaves out blanks its buffer to -1 before
    the gather, so it contributes nothing to the merge."""
    shard = _shard_linear_index(mesh)
    local = _shard_rows(data, mesh, shard)
    gids, gcnt = _part_topk(plan, local, _local(queries), shard * int(local.shape[0]))
    if shard_active is not None and not shard_active[shard]:
        gids, gcnt = torch.full_like(gids, -1), torch.full_like(gcnt, -1)
    return _collective_merge(plan, mesh, gids, gcnt)


def _run_routed_sharded(plan: QueryPlan, data, queries, mesh,
                        router: Optional["_routing.Router"],
                        route_queries) -> TopKResult:
    """Routed DISTRIBUTED execution: segments map onto the shards whose row
    ranges they overlap, unrouted shards blank their candidate buffers, and
    ROUTED_VERIFIED re-runs the full scan when a segment with any inactive
    shard could still reach the routed threshold.  Every rank routes the
    same queries on the host and reads the same replicated threshold, so all
    of them take the same branch."""
    mask, ubs = _route(plan, router, _local(queries),
                       None if route_queries is None else _local(route_queries))
    n_total = int(data.shape[0])
    n_shards = mesh.size()
    n_local = max(n_total // n_shards, 1)
    if sum(router.part_rows) > n_total:
        raise ValueError(
            f"router summarises {sum(router.part_rows)} rows but the sharded "
            f"data holds {n_total}; rebuild the router from the current "
            f"segments"
        )
    active = _routing.shard_mask(router.part_rows, mask, n_local, n_shards)
    res = _run_sharded(plan, data, queries, mesh, shard_active=active)
    if plan.routing is Routing.ROUTED:
        return res
    # a segment fully covered by active shards was scanned (possibly as a
    # bonus rider on a routed neighbour's shard) -- verify only the rest
    verify = _routing.segments_needing_verify(router.part_rows, active, n_local)
    if not _skipped_could_contribute(res, ubs, verify):
        return res
    return _run_sharded(plan, data, queries, mesh)


def execute(plan: QueryPlan, data, queries, mesh=None,
            router: Optional["_routing.Router"] = None,
            route_queries=None) -> TopKResult:
    """Run a planned search.  The only public door to the match/select/merge
    machinery -- every index/serving entry point delegates here.

    `data` follows the layout: one tensor (MONOLITHIC), a list of per-part
    tensors (SEGMENTED), a stacked [C, Nc, ...] tensor (scanned MULTILOAD), a
    list of per-part tensors or numpy arrays, on the device or in host
    memory (MULTILOAD host loop), or -- on every rank of `mesh=`, a
    `DeviceMesh` (launch/mesh.py) -- a DTensor placed with
    `distributed.data_sharding(mesh)` or the whole tensor (DISTRIBUTED; the
    queries as a DTensor replicated on the mesh or a plain tensor).  A
    DISTRIBUTED plan returns the same result on every rank; other layouts
    ignore `mesh=`, as in the reference.

    Routed plans (`plan.routing` != NONE) need `router=` -- a
    `routing.Router` over the current segments' summaries
    (`SegmentedIndex.router()`).  `route_queries=` supplies the canonical
    WIDE queries the summaries score against; it defaults to `queries` and
    must be passed whenever `queries` are PACKED (the router cannot read
    packed words)."""
    if plan.layout == Layout.DISTRIBUTED:
        if mesh is None:
            raise ValueError("a DISTRIBUTED plan executes on a mesh; pass mesh=")
        if plan.routing is not Routing.NONE:
            return _run_routed_sharded(plan, data, queries, mesh, router,
                                       route_queries)
        return _run_sharded(plan, data, queries, mesh)
    if plan.layout == Layout.SEGMENTED or (plan.layout == Layout.MULTILOAD and plan.host_loop):
        return _run_host_parts(plan, data, queries, router=router,
                               route_queries=route_queries)
    if plan.layout == Layout.MULTILOAD:
        return _run_scan(plan, data, queries)
    return _run_monolithic(plan, data, queries)
