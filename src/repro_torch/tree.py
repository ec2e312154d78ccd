"""Nested parameter trees (no counterpart in the JAX package, which has
`jax.tree_util`).

A tree is a dict (walked in sorted key order, as `jax.tree_util` walks
one), a list or tuple (in order), None (no leaves) or a leaf tensor.  The
port's parameter trees hold one dict per layer in a list where the
reference stacks a leading layer axis; the checkpointer restacks them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def leaves(tree) -> list[torch.Tensor]:
    """The leaves of `tree` in walk order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in leaves(node)]
    return [tree]


def leaf_keys(tree, path: tuple = ()) -> list[tuple]:
    """The path of each leaf, in the order of `leaves`, with list positions
    left out: leaves of one key are the layers of one of the reference's
    stacked leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_keys(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in leaf_keys(node, path)]
    return [path]


def map_tree(fn: Callable, tree, *rest):
    """`fn` applied leaf by leaf to `tree` and the trees of the same
    structure in `rest`, in the order of `leaves`; the result has `tree`'s
    structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("map_tree: trees of different lengths")
        return type(tree)(map_tree(fn, *nodes) for nodes in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(tree, flat: list):
    """The leaves `flat` (in the order of `leaves(tree)`) in `tree`'s
    structure."""
    it = iter(flat)
    out = map_tree(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of `t` (never sharing its memory); bfloat16 as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def stacked_numpy(tree, leaf: Callable = host_array):
    """`tree` as nested dicts of numpy arrays (`leaf` of each tensor), every
    list stacked on a new leading axis: a list of per-layer dicts becomes
    one dict of [L, ...] arrays, a list of lists [n, m, ...], as the
    reference stacks its layers."""
    if isinstance(tree, dict):
        return {k: stacked_numpy(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _stack([stacked_numpy(x, leaf) for x in tree])
    return leaf(tree)


def _stack(parts: list):
    if isinstance(parts[0], dict):
        return {k: _stack([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)
