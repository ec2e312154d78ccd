"""Activation-sharding hints: the counterpart of `repro/models/partition.py`,
name for name.

`hint(x, roles...)` places a DTensor activation as its per-dim logical roles
say, resolved against the ambient mesh (`launch/mesh.use_mesh`):

    "dp"  -> batch-like dim over ("pod", "data") (whichever exist)
    "tp"  -> feature-like dim over "model"
    "dpt" -> the whole mesh (the DP axes and "model" together)
    "rep" / None -> unsharded

Each role is applied only when the dim size divides the axis size -- the
same degrade-per-tensor policy as launch/sharding.py.  Where the reference
adds a `with_sharding_constraint` and lets XLA insert the collective, the
port `redistribute`s the DTensor to those placements (autograd carries the
opposite collective into the backward).  With no ambient mesh, or on a
plain tensor, `hint` returns its input itself: model code runs unchanged
on one device and every unsharded path computes what it computed before.

Where DTensor's rules cannot carry an operation, one named helper here
does it explicitly (each site is listed in PERF.md), and its result is a
DTensor again:

  * `replicate_operand`: an operand gathered to `Replicate()` for an
    operation DTensor has no rule for, or no rule in every release: the
    MoE's routing (a cumsum over every token into [E, C] buffers), its
    buffers before the combine's gather, a sharded table before
    `layers.gather_rows` (the FSDP gather of the embedding), a batch before
    a microbatch's rows are cut from it;
  * `on_replicas`: an operation DTensor has no rule for in every release
    (`index_put_`: none in torch 2.11) run on every rank's whole copy of its
    operands -- each DTensor operand replicated, the operation on the local
    tensors, the result a replicated DTensor: the gradient's scatter in
    `layers.gather_rows`, the MoE's dispatch buffers;
  * `split_ready`: a dim about to be split into (n, size / n) -- the
    projections' features into heads -- gathered on the mesh dims whose
    shards would cut one of the n groups (DTensor's view rules refuse an
    uneven unflatten; smollm's 15 heads over a model axis of 2, say);
  * `keep_grad_layout`: the counterpart of `split_ready` for the backward:
    x itself in the forward, and its gradient brought to x's own placements
    before it flows into the reshape it came from (the heads merged back
    into features: the row-parallel projection after them returns a
    gradient sharded over the features, which the merge's backward would
    split; the MoE's tokens back to [B, S, D]: the residual's gradient may
    come back sequence-sharded, which the reshape's backward would flatten);
  * `gather_sequence`: the sequence-parallel residual's all-gather, where
    a sequence-sharded activation enters a matmul (attention, MLP, MoE,
    cross-attention memory, the head): GSPMD inserts it there; DTensor's
    view rules in some releases (torch 2.11) refuse the einsum's flattening
    of a batch and a sharded sequence dim;
  * `per_batch_shards`: the SSD core (`ssm.ssd_chunked`, `ssd_decode`) run
    on each rank's batch rows, every other dim replicated: it is
    independent across batch rows, and its einsums' reshapes and its
    cumsum's backward (`aten.flip`, no rule in torch 2.11) stay local;
  * `per_head_shards`: the attention core, run shard by shard.  DTensor's
    view rules refuse the reshapes inside its einsums once both the batch
    and the head dim are sharded; the core is independent across batch rows
    and head groups, so q, k and v are brought to one layout -- batch as q
    has it, heads over "model" where both q's and k's heads are, everything
    else replicated -- and the core runs on each rank's local shards
    (`local_map`), as GSPMD partitions it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch

# Per-call policy: archs with use_tp=False treat the "model" axis as extra
# data parallelism (see ModelConfig.use_tp).  Set by the family forward
# functions around their bodies.
_USE_TP = contextvars.ContextVar("repro_torch_use_tp", default=True)


@contextlib.contextmanager
def tp_policy(use_tp: bool):
    tok = _USE_TP.set(use_tp)
    try:
        yield
    finally:
        _USE_TP.reset(tok)


def snapshot():
    """A context manager factory that re-enters the current hint policy and
    ambient mesh: activation checkpointing recomputes a block in the
    backward, outside the forward's `tp_policy` / `use_mesh`, and its hints
    must resolve as they did the first time."""
    from repro_torch.launch import mesh as mesh_lib

    use_tp, mesh = _USE_TP.get(), mesh_lib.current_mesh()

    @contextlib.contextmanager
    def again():
        tok = _USE_TP.set(use_tp)
        mtok = mesh_lib._AMBIENT.set(mesh)
        try:
            yield
        finally:
            mesh_lib._AMBIENT.reset(mtok)
            _USE_TP.reset(tok)

    return again


@contextlib.contextmanager
def sharded_scope(mesh):
    """The scope sharded model code runs in: `mesh` ambient (`use_mesh`, so
    the hints resolve against it) and DTensor's `implicit_replication` (the
    plain tensors the model code makes -- positions, masks, RoPE tables --
    meet the DTensors as replicated).  Nothing with `mesh` None."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import use_mesh

    with use_mesh(mesh), implicit_replication():
        yield


def _ambient_mesh():
    from repro_torch.launch import mesh as mesh_lib

    return mesh_lib.current_mesh()


def _mesh_axes() -> Optional[dict]:
    """{axis name: size} of the ambient mesh, or None outside one."""
    mesh = _ambient_mesh()
    if mesh is None:
        return None
    from repro_torch.launch import mesh as mesh_lib

    return mesh_lib.axis_sizes(mesh)


def _resolve(role: Optional[str], dim: int, axes: dict):
    """One dim's spec entry: an axis name, a tuple of axis names, or None."""
    use_tp = _USE_TP.get()
    if role == "dp":
        names = ("pod", "data") if use_tp else ("pod", "data", "model")
        base = tuple(a for a in names if a in axes)
        # contiguous subsets, largest first (see launch/sharding.py note)
        cands = [base[i:j] for i in range(len(base)) for j in range(len(base), i, -1)]
        cands.sort(key=lambda c: -math.prod(axes[a] for a in c))
        for cand in cands:
            total = math.prod(axes[a] for a in cand)
            if dim % total == 0:
                return cand if len(cand) > 1 else cand[0]
        return None
    if role == "tp":
        if use_tp and "model" in axes and dim % axes["model"] == 0:
            return "model"
        return None
    if role == "dpt":  # full-mesh shard (DP axes + model together)
        cand = tuple(a for a in ("pod", "data", "model") if a in axes)
        while cand:
            total = math.prod(axes[a] for a in cand)
            if dim % total == 0:
                return cand if len(cand) > 1 else cand[0]
            cand = cand[:-1]
        return None
    if role == "rep":  # explicitly replicated (forces an FSDP weight gather)
        return None
    return None


def placements(spec: tuple, axes: dict) -> list:
    """A spec (one entry a tensor dim: None, an axis name or a tuple of axis
    names) as DTensor placements on a mesh of `axes` ({name: size}, in the
    mesh's order), one a mesh dim: `Shard(i)` where the spec names that axis
    at dim i, `Replicate()` where it does not.  A dim over ("data", "model")
    is `Shard(i)` on both; DTensor nests its shards in mesh-dim order, which
    is the row-major order of `P(("data", "model"))`
    (tests/test_torch_distributed.py holds each rank's shard to the
    reference's).  Where a dim is named with several axes, those of size 1
    are left `Replicate()` (they split nothing), keeping one when all are of
    size 1: the layout is the same, and DTensor's rules in some releases
    (torch 2.11's `aten.index`) refuse one dim sharded on two mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for i, entry in enumerate(spec):
        names = [n for n in (entry if isinstance(entry, tuple) else (entry,)) if n is not None]
        unknown = [n for n in names if n not in axes]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} not in {tuple(axes)}")
        for name in names:
            if name in dim_of:
                raise ValueError(f"axis {name!r} names two dims of {spec}")
            dim_of[name] = i
        ones = [n for n in names if axes[n] == 1]
        for name in (ones[:-1] if len(ones) == len(names) else ones) if len(names) > 1 else []:
            dim_of[name] = None
    return [Shard(dim_of[a]) if dim_of.get(a) is not None else Replicate() for a in axes]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def hint(x: torch.Tensor, *roles):
    """Place x by per-dim logical roles (its input itself without a mesh or
    on a plain tensor)."""
    axes = _mesh_axes()
    if axes is None or not _is_dtensor(x):
        return x
    assert len(roles) == x.ndim, (roles, tuple(x.shape))
    spec = tuple(_resolve(r, d, axes) for r, d in zip(roles, x.shape))
    want = placements(spec, axes)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicate_operand(x: torch.Tensor) -> torch.Tensor:
    """x gathered to `Replicate()` on every mesh dim, for an operation that
    DTensor has no sharding rule for (its input itself on a plain tensor)."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = [Replicate()] * x.device_mesh.ndim
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def on_replicas(fn, *tensors):
    """`fn` on the local tensors of `tensors` once each DTensor among them
    is replicated (`replicate_operand`), its result (a tensor or a tuple of
    them) returned as replicated DTensors on that mesh; every rank computes
    the same values from the same operands.  With no DTensor operand, `fn`
    on `tensors` as they are.  Differentiable: `to_local` and `from_local`
    carry the gradient."""
    dts = [t for t in tensors if _is_dtensor(t)]
    if not dts:
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    out = fn(*(replicate_operand(t).to_local() if _is_dtensor(t) else t for t in tensors))

    def wrap(o):
        return DTensor.from_local(o, mesh, rep, run_check=False)

    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)


def split_ready(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x, gathered on the mesh dims that shard `dim` when their shards do not
    fall on the boundaries of `n` equal groups of it (its input itself
    otherwise, and on a plain tensor)."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    mesh = x.device_mesh
    over = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    if not over or n % math.prod(mesh.size(i) for i in over) == 0:
        return x
    want = [Replicate() if p == Shard(dim) else p for p in x.placements]
    return x.redistribute(mesh, want)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """x ([B, S, ...]) with its sequence dim gathered on every mesh dim that
    shards it, its other placements kept (its input itself otherwise)."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = [Replicate() if p == Shard(1) else p for p in x.placements]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def per_batch_shards(core, *args, batched: tuple, n_out: int = 2):
    """`core(*args)` on each rank's batch rows: per mesh dim, `Shard(0)`
    for the operands flagged in `batched` (batch-major) where the first of
    them shards its batch there, `Replicate()` otherwise; every other operand
    replicated.  `core` returns `n_out` batch-major tensors, placed as the
    batched operands.  With no DTensor operand, `core` on `args` as they
    are; a None operand stays None."""
    if not any(_is_dtensor(a) for a in args):
        return core(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = next(a for a, b in zip(args, batched) if b and _is_dtensor(a))
    mesh = lead.device_mesh
    rep = [Replicate()] * mesh.ndim
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in lead.placements]
    placed, in_pl = [], []
    for a, b in zip(args, batched, strict=True):
        if a is None:
            placed.append(None)
            in_pl.append(None)
            continue
        want = rows if b else rep
        if not _is_dtensor(a):
            a = DTensor.from_local(a, mesh, rep, run_check=False)
        placed.append(a if list(a.placements) == want else a.redistribute(mesh, want))
        in_pl.append(want)
    fn = local_map(core, out_placements=(rows,) * n_out,
                   in_placements=tuple(in_pl), device_mesh=mesh)
    return fn(*placed)


class _KeepGradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, list(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, want = ctx.layout
        return grad if list(grad.placements) == want else grad.redistribute(mesh, want)


def keep_grad_layout(x: torch.Tensor) -> torch.Tensor:
    """x itself; in the backward, its gradient redistributed to x's
    placements (a plain tensor is returned as it is)."""
    if not _is_dtensor(x) or not x.requires_grad:
        return x
    return _KeepGradLayout.apply(x)


def per_head_shards(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw):
    """`core(q, k, v, **kw)` -> [B, Sq, H, D] (q: [B, Sq, H, D]; k, v:
    [B, Sk, KV, D]) on each rank's shards of a common layout: per mesh dim,
    the batch dim where q shards it, the head dims where q's and k's heads
    are both sharded (each rank's q heads then group onto its own kv heads),
    `Replicate()` otherwise.  Plain tensors go to `core` as they are."""
    if not (_is_dtensor(q) or _is_dtensor(k) or _is_dtensor(v)):
        return core(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (q, k, v) if _is_dtensor(t))
    rep = [Replicate()] * mesh.ndim
    qp = list(q.placements) if _is_dtensor(q) else rep
    kp = list(k.placements) if _is_dtensor(k) else rep
    want = []
    for a, b in zip(qp, kp):
        if a == Shard(0):
            want.append(Shard(0))
        elif a == Shard(2) and b == Shard(2):
            want.append(Shard(2))
        else:
            want.append(Replicate())
    args = []
    for t in (q, k, v):
        if not _is_dtensor(t):
            from torch.distributed.tensor import DTensor

            t = DTensor.from_local(t, mesh, rep, run_check=False)
        args.append(t if list(t.placements) == want else t.redistribute(mesh, want))
    fn = local_map(lambda q_, k_, v_: core(q_, k_, v_, **kw), out_placements=want,
                   in_placements=(want, want, want), device_mesh=mesh)
    return fn(*args)
