"""Distributed GENIE search over a (pod, data, model) device mesh, on
torch.distributed: the counterpart of `repro/core/distributed.py`.

Objects are partitioned across *every* mesh axis (a pure data-parallel object
shard -- the match-count of an object depends only on its own data row),
queries are replicated, each shard runs the dense match + top-k on its local
partition, and the per-shard candidate buffers are merged with an
all-gather + small-buffer select.  This is the paper's multiple-loading merge
turned into a collective.

The reference runs this from one controller under `shard_map`; the port runs
it SPMD, one process per rank, each calling the step on the same arguments
(launch/mesh.py says how the ranks and the mesh are made).  Its placements:
`data_sharding(mesh)` is `Shard(0)` on every mesh dimension -- rank r holds
the r-th row block in the row-major order of the mesh axes, the order of the
reference's `P(tuple(axes))` -- and `replicated` is `Replicate()` on every
dimension; `torch.distributed.tensor.distribute_tensor(x, mesh, placements)`
places a tensor, as `jax.device_put` does there.

Both step builders are thin adapters over the unified planner (core/plan.py):
they describe the search as a DISTRIBUTED `QueryPlan` and return a step that
executes it on the mesh, so the per-shard body -- match dispatch, pad
masking, selection, collective merge -- lives in exactly one place.  The
port runs eagerly, so a step is a plain closure over `plan.execute`, not a
compiled executable, and the reference's `shard_map_compat` (a jax version
shim for `shard_map`) has no counterpart.

Engines are resolved through the MatchModel registry (core/engines.py): pass
an `Engine`, its string value, a `MatchModel`, or a raw canonical callable
``fn(data, queries) -> counts`` (such as `match.match_eq`).
`SearchParams.use_kernel` selects the per-shard match: the CUDA kernels on a
CUDA mesh, their plain versions on a CPU one.

Communication cost per query batch: S * Q * k * 8 bytes of (id, count) pairs
-- independent of N, the point of shipping candidate buffers instead of
counts.
"""
from __future__ import annotations

from typing import Any, Callable, Union

import torch

from repro_torch.core import engines as _engines
from repro_torch.core import plan as _plan
from repro_torch.core.types import Engine, SearchParams, SignatureLayout, TopKResult

shard_linear_index = _plan._shard_linear_index

MatchLike = Union[Engine, str, "_engines.MatchModel",
                  Callable[[torch.Tensor, Any], torch.Tensor]]


def _plan_sharded(mesh, params: SearchParams, match_fn: MatchLike,
                  n_objects: int | None, hierarchical: bool,
                  signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
                  ) -> _plan.QueryPlan:
    return _plan.plan_search(
        match_fn, params.k, params.max_count, layout=_plan.Layout.DISTRIBUTED,
        n_objects=n_objects, method=params.method,
        candidate_cap=params.candidate_cap, use_kernel=params.use_kernel,
        hierarchical=hierarchical, mesh_axes=_plan._mesh_axes(mesh),
        signature_layout=signature_layout,
    )


def _step(plan: _plan.QueryPlan, mesh) -> Callable[[Any, Any], TopKResult]:
    def step(data, queries) -> TopKResult:
        return _plan.execute(plan, data, queries, mesh=mesh)

    return step


def make_search_step(
    mesh,
    params: SearchParams,
    match_fn: MatchLike,
    n_objects: int | None = None,
    signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
) -> Callable[[Any, Any], TopKResult]:
    """Build the distributed search step, called on every rank of `mesh`.

    data:    [N, ...] (N divisible by the total mesh size): a DTensor placed
             with `data_sharding(mesh)`, or the whole tensor on every rank.
    queries: canonical queries (each tensor [Q, ...]), the same on every
             rank (a plain tensor or a DTensor placed with `replicated`).
    Returns the TopKResult with global object ids, the same on every rank.

    `n_objects` enables the *segmented* shard layout: data is segments
    concatenated in global-id order and padded up to mesh divisibility
    (SegmentedIndex.concat_data), and rows with global id >= n_objects are
    pad fill -- their counts are forced to -1 before per-shard selection so
    they can never reach any candidate buffer.

    `signature_layout=PACKED` dispatches the packed per-shard match kernels:
    data and queries must arrive already packed (a PACKED SegmentedIndex's
    concat_data / the engine's prepare_queries_for produce them).
    """
    plan = _plan_sharded(mesh, params, match_fn, n_objects, hierarchical=False,
                         signature_layout=signature_layout)
    return _step(plan, mesh)


def make_hierarchical_search_step(
    mesh,
    params: SearchParams,
    match_fn: MatchLike,
    n_objects: int | None = None,
    signature_layout: SignatureLayout | str = SignatureLayout.WIDE,
) -> Callable[[Any, Any], TopKResult]:
    """Two-level merge variant: reduce candidate buffers inside a pod first,
    then across pods -- merge order does not change the result (merge is
    associative on partitioned objects), but the inter-pod traffic drops from
    S*Q*k to P_pods*Q*k pairs.

    Only meaningful on meshes with a leading "pod" axis; the flat merge
    otherwise.  `n_objects` masks segmented-layout pad rows, exactly as in
    `make_search_step`.
    """
    hier = _plan._mesh_axes(mesh)[:1] == ("pod",)
    plan = _plan_sharded(mesh, params, match_fn, n_objects, hierarchical=hier,
                         signature_layout=signature_layout)
    return _step(plan, mesh)


def data_sharding(mesh) -> list:
    """Placements of the object-partitioned data matrix [N, ...]."""
    from torch.distributed.tensor import Shard

    return [Shard(0)] * mesh.ndim


def replicated(mesh, ndim: int) -> list:
    """Placements of a tensor every rank holds whole (`ndim`, the tensor's
    rank, is the reference's argument; a placement does not depend on it)."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim
