"""Sharding policy: map every parameter / batch / cache tensor onto the
(pod, data, model) mesh with per-dimension divisibility checks.  The
counterpart of `repro/launch/sharding.py`, name for name.

Strategy (the reference's):
  * TP over "model": the largest divisible non-stack dimension of each weight
    (d_ff, head, or vocab dim in practice -- Megatron-style), biases/norms
    replicated.
  * FSDP (ZeRO-3) over "data": the largest remaining divisible dimension of
    each weight; optimizer moments inherit the same spec.
  * DP over ("pod", "data") for batch dims; parameters are replicated across
    "pod".
  * Layer-stack leading dims stay unsharded.
  * KV caches: batch over DP when divisible; kv-heads over "model" when
    divisible, else head_dim.

Each policy is split in two.  The pure half (`param_spec`, `params_specs`,
`state_specs`, `batch_specs`, `cache_specs`) works on `axes`, a
{axis name: size} dict, and returns the reference's `PartitionSpec` entries
as a tuple (None, an axis name, or a tuple of axis names per tensor dim); it
needs no process group, so the dry-run and the tests call it with any mesh
shape.  The thin wrappers (`params_shardings`, `state_shardings`,
`batch_shardings`, `cache_shardings`, `replicated`) take a `DeviceMesh` and
return a `Sharding(mesh, spec, placements)` per leaf, the placements being
DTensor's (`partition.placements`).

Per-layer leaves.  The port stores one dict per layer in a list where the
reference stacks a leading axis ([L, ...]; the hybrid's `mamba` is
[n_inv, period, ...]).  A leaf's spec is computed on the reference's stacked
shape -- the list lengths along its path prepended -- and the stack entries
(always None) are then dropped: the rule is never re-derived on the
per-layer shape, whose largest dim may differ.  Cache tensors are stacked in
the port as in the reference and keep every entry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

from repro_torch.models.config import ModelConfig

# tree keys whose leaves carry the reference's scan stacks
_STACK1 = ("blocks", "enc_blocks", "dec_blocks", "lora")
_STACK2 = ("mamba",)  # hybrid: [n_inv, period, ...]


def _n_stack_dims(keys: list[str]) -> int:
    for k in keys:
        if k in _STACK2:
            return 2
        if k in _STACK1:
            return 1
    return 0


# Megatron-style TP placement by weight name: which (negative, post-stack)
# dim is sharded over "model".  Column-parallel weights shard their OUTPUT
# dim (no extra comm); row-parallel weights shard their INPUT dim (one
# activation all-reduce after the matmul).
_TP_RULES: dict[str, int | None] = {
    # attention: qkv column-parallel (heads out), wo row-parallel (heads in)
    "wq": -1, "wk": -1, "wv": -1, "wo": -2,
    # MLP: gate/up column-parallel (d_ff out), down row-parallel (d_ff in)
    "w_gate": -1, "w_up": -1, "w_down": -2,
    # embeddings: vocab-parallel table; head column-parallel (vocab out)
    "embed": -2, "lm_head": -1,
    # mamba2: fused in_proj stays model-replicated (its packed z|xBC|dt split
    # does not align with shard boundaries); out_proj row-parallel
    "in_proj": None, "out_proj": -2, "conv_w": -1,
    # MoE: per-expert d_ff sharded
    "router": None,
    # zamba2 LoRA: B column-parallel, A replicated over model
    "a_q": None, "b_q": -1,
    "shared_gate": None,
}

Spec = tuple  # one entry a tensor dim: None, an axis name, or a tuple of names


class Sharding(NamedTuple):
    """One leaf's layout on a mesh: the reference's spec and DTensor's
    placements (one a mesh dim, in the mesh's order)."""
    mesh: Any
    spec: Spec
    placements: tuple


def _sizes(mesh) -> dict[str, int]:
    from repro_torch.launch import mesh as mesh_lib

    return mesh_lib.axis_sizes(mesh)


def _wrap(mesh, spec: Spec) -> Sharding:
    from repro_torch.models.partition import placements

    return Sharding(mesh, tuple(spec), tuple(placements(tuple(spec), _sizes(mesh))))


def _map(fn, tree, path: tuple = (), stack: tuple = ()):
    """`fn(keys, stack, leaf)` on every leaf of a port tree (dicts, lists,
    dataclasses, None), in its structure: `keys` are the dict keys along the
    path, `stack` the lengths of the lists along it."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name), path + (f.name,), stack)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),), stack) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x, path, stack + (len(tree),)) for x in tree)
    return fn(list(path), stack, tree)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_spec(name: str, shape: tuple[int, ...], n_stack: int, tp: int, dp: int,
               use_tp: bool = True) -> Spec:
    """The reference's spec of one leaf of the reference's (stacked) shape."""
    axes: list[Any] = [None] * len(shape)
    free = list(range(n_stack, len(shape)))
    if len(free) >= 2:
        tp_dim = None
        rule = _TP_RULES.get(name, -1)  # default: column-parallel last dim
        if use_tp and rule is not None:
            cand = len(shape) + rule if rule < 0 else n_stack + rule
            if cand in free and shape[cand] % tp == 0:
                tp_dim = cand
                axes[tp_dim] = "model"
        rest = sorted((i for i in free if i != tp_dim), key=lambda i: -shape[i])
        # FSDP: without TP the "model" axis joins the ZeRO shard group.
        fsdp_groups = (("data",),) if use_tp else (("data", "model"), ("data",), ("model",))
        done = False
        for grp in fsdp_groups:
            size = dp if grp == ("data",) else (
                dp * tp if len(grp) == 2 else tp
            )
            for i in rest:
                if shape[i] % size == 0:
                    axes[i] = grp if len(grp) > 1 else grp[0]
                    done = True
                    break
            if done:
                break
    # 1-D (biases / norms / A_log): replicate
    return tuple(axes)


def leaf_spec(keys: list[str], stack: tuple, shape: tuple, axes: dict,
              use_tp: bool = True) -> Spec:
    """A port leaf's spec: `param_spec` on the reference's stacked shape
    (`stack` + `shape`), the stack entries dropped."""
    n_stack = _n_stack_dims(keys)
    if len(stack) != n_stack:
        raise ValueError(f"{'/'.join(keys)}: {len(stack)} list levels where the reference "
                         f"stacks {n_stack} dims")
    name = keys[-1] if keys else ""
    full = param_spec(name, tuple(stack) + tuple(shape), n_stack, int(axes["model"]),
                      int(axes["data"]), use_tp)
    assert all(e is None for e in full[:n_stack]), (keys, full)
    return full[n_stack:]


def params_specs(params: Any, axes: dict, use_tp: bool = True) -> Any:
    """The spec of every leaf of the port's parameter tree (tensors, meta
    tensors or anything with a `.shape`), in its structure."""
    return _map(lambda keys, stack, leaf: leaf_spec(keys, stack, tuple(leaf.shape), axes,
                                                    use_tp), params)


def params_shardings(params: Any, mesh, use_tp: bool = True) -> Any:
    axes = _sizes(mesh)
    return _map(lambda keys, stack, leaf: _wrap(mesh, leaf_spec(keys, stack, tuple(leaf.shape),
                                                                axes, use_tp)), params)


def state_specs(state: Any, params_sp: Any) -> Any:
    """TrainState specs: params / m / v / compress_error share the
    parameters' specs; the step (and any other scalar) is replicated."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    return TrainState(
        params=params_sp,
        opt=AdamWState(m=params_sp, v=params_sp, step=()),
        compress_error=params_sp if state.compress_error is not None else None,
    )


def state_shardings(state: Any, params_sh: Any, mesh) -> Any:
    """TrainState shardings: params/m/v share specs; scalars replicated."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    return TrainState(
        params=params_sh,
        opt=AdamWState(m=params_sh, v=params_sh, step=replicated(mesh)),
        compress_error=params_sh if state.compress_error is not None else None,
    )


# ---------------------------------------------------------------------------
# Batch / cache
# ---------------------------------------------------------------------------

def _dp_axes(axes: dict) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axes else ("data",)


def batch_spec(shape: tuple, axes: dict, use_tp: bool = True) -> Spec:
    dpa = _dp_axes(axes)
    if not use_tp:
        dpa = dpa + ("model",)
    # candidate axis groups, largest first; contiguous subsets (not only
    # prefixes): global_batch=256 on the 512-rank mesh divides (data, model)
    # but not (pod, data, model)
    cands = [dpa[i:j] for i in range(len(dpa)) for j in range(len(dpa), i, -1)]
    cands.sort(key=lambda c: -math.prod(axes[a] for a in c))
    spec: list[Any] = [None] * len(shape)
    for cand in cands:
        total = math.prod(axes[a] for a in cand)
        if shape and shape[0] % total == 0:
            spec[0] = cand if len(cand) > 1 else cand[0]
            break
        if len(shape) > 1 and shape[1] % total == 0:
            spec[1] = cand if len(cand) > 1 else cand[0]  # SP fallback
            break
    return tuple(spec)


def batch_specs(batch_shapes: dict, axes: dict, use_tp: bool = True) -> dict:
    return {k: batch_spec(tuple(v.shape), axes, use_tp) for k, v in batch_shapes.items()}


def batch_shardings(batch_shapes: dict, mesh, use_tp: bool = True) -> dict:
    return {k: _wrap(mesh, spec)
            for k, spec in batch_specs(batch_shapes, _sizes(mesh), use_tp).items()}


def _shard_batch_dim(spec: list, dim: int, size: int, axes: dict, dpa: tuple) -> set:
    """Greedy: shard `dim` over the longest divisible prefix of dpa.
    Returns the axes actually used (so other dims avoid them)."""
    cand = tuple(dpa)
    while cand:
        total = math.prod(axes[a] for a in cand)
        if size % total == 0:
            spec[dim] = cand if len(cand) > 1 else cand[0]
            return set(cand)
        cand = cand[:-1]
    return set()


def cache_spec(cfg: ModelConfig, name: str, shape: tuple, axes: dict) -> Spec:
    """One cache leaf's spec.  Decode caches dominate serving memory: batch
    over the longest divisible DP prefix, kv-heads/head_dim over "model" when
    free, and finally the cache length itself over whatever axis remains."""
    dpa = _dp_axes(axes)
    if not cfg.use_tp_serve:   # caches exist only on the serve path
        dpa = dpa + ("model",)
    tp = int(axes["model"])
    spec: list[Any] = [None] * len(shape)
    if name in ("k", "v", "attn_k", "attn_v"):    # [L/I, B, cap, KV, hd]
        used = _shard_batch_dim(spec, 1, shape[1], axes, dpa)
        cap, kvh, hd = shape[2], shape[3], shape[4]
        if "model" not in used:
            if kvh % tp == 0:
                spec[3] = "model"
            elif hd % tp == 0:
                spec[4] = "model"
            elif cap % tp == 0:
                spec[2] = "model"
        elif "data" not in used and cap % int(axes["data"]) == 0:
            spec[2] = "data"
        return tuple(spec)
    if name == "memory":                       # [B, S, D]
        used = _shard_batch_dim(spec, 0, shape[0], axes, dpa)
        if "model" not in used and shape[-1] % tp == 0:
            spec[-1] = "model"
        return tuple(spec)
    if name == "ssm":                          # [L(,P), B, h, n, p]
        bdim = len(shape) - 4
        used = _shard_batch_dim(spec, bdim, shape[bdim], axes, dpa)
        if "model" not in used and shape[bdim + 1] % tp == 0:
            spec[bdim + 1] = "model"
        return tuple(spec)
    if name == "conv":                         # [L(,P), B, W-1, cch]
        bdim = len(shape) - 3
        used = _shard_batch_dim(spec, bdim, shape[bdim], axes, dpa)
        if "model" not in used and shape[-1] % tp == 0:
            spec[-1] = "model"
        return tuple(spec)
    # fallback: replicate
    return tuple(spec)


def cache_specs(cfg: ModelConfig, cache_shapes: dict, axes: dict) -> dict:
    return {k: cache_spec(cfg, k, tuple(v.shape), axes) for k, v in cache_shapes.items()}


def cache_shardings(cfg: ModelConfig, cache_shapes: dict, mesh) -> dict:
    return {k: _wrap(mesh, spec)
            for k, spec in cache_specs(cfg, cache_shapes, _sizes(mesh)).items()}


def replicated(mesh) -> Sharding:
    return _wrap(mesh, ())


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------

def place(x, sharding: Sharding):
    """`x` with `sharding`'s placements.  A plain tensor is the whole value,
    the same on every rank: each rank keeps its own shard and nothing is
    sent (`src_data_rank=None`).  A DTensor is redistributed.  A leaf that
    requires grad gives a DTensor leaf that requires grad."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, list(sharding.placements))
    grad = x.requires_grad
    out = distribute_tensor(x.detach(), sharding.mesh, list(sharding.placements),
                            src_data_rank=None)
    return out.requires_grad_(grad)


def leaves_of(shardings) -> list:
    """The `Sharding` leaves of a tree of them, in walk order."""
    if shardings is None:
        return []
    if isinstance(shardings, Sharding):
        return [shardings]
    if dataclasses.is_dataclass(shardings) and not isinstance(shardings, type):
        return [x for f in dataclasses.fields(shardings)
                for x in leaves_of(getattr(shardings, f.name))]
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings) for x in leaves_of(shardings[k])]
    return [x for node in shardings for x in leaves_of(node)]


def place_tree(tree, shardings):
    """Every leaf of `tree` placed by the `Sharding` at the same place in
    `shardings` (the same structure)."""
    if tree is None:
        return None
    if isinstance(shardings, Sharding):
        return place(tree, shardings)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: place_tree(getattr(tree, f.name), getattr(shardings, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(place_tree(x, s) for x, s in zip(tree, shardings, strict=True))
