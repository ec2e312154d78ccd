"""Checkpointing with atomic commit: the counterpart of
`repro/checkpoint/checkpointer.py`, name for name, in the reference's
on-disk layout.

Layout:  <dir>/step_<N>/
             manifest.json        {"step", "n_leaves", "extra"}
             arrays.npz           flattened leaves (key = joined tree path)

The keys and arrays are the reference's: `params/...`, `opt/m/...`,
`opt/v/...`, `opt/step` (0-d int32) and `compress_error/...` (none when
compression is off), in the reference's leaf order, each list of layers
stacked on a leading axis (`params/blocks/attn/wq` is [L, d, d]).  So each
package restores the other's checkpoint.  A bfloat16 leaf is stored as the
reference stores one, as raw two-byte `|V2` items (numpy has no bfloat16),
and restored by reinterpreting those bytes as bfloat16; the reference's own
`restore` cannot cast them (ROADMAP queue 3).

Writes go to step_<N>.tmp and are os.rename'd -- a preempted save never
corrupts the latest checkpoint.  `save` copies every leaf to the host
before it returns or starts its thread (a consistent cut: the trainer
updates the state in place right after).

Sharded state (DTensor leaves): `save` gathers each leaf whole with
`full_tensor()` on every rank (a collective, so every rank calls `save`),
rank 0 alone writes, and on a world of several ranks the write is
synchronous and followed by a barrier, so no rank goes on (to `prune`,
`latest_step` or a restore) before the rename has committed the step.
`restore(..., shardings)` reads the whole arrays on every rank and places
each leaf with the *target* sharding (`launch/sharding.place`), so a
checkpoint written on any mesh shape -- or by the reference -- restores
onto any other (elastic shrink / grow).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, stacked_numpy

_BF16_BYTES = np.dtype("V2")      # what np.savez writes for an ml_dtypes bfloat16 array


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` (a DTensor's whole value); bfloat16 as its raw
    two-byte items."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(_BF16_BYTES)
    return t.to("cpu", copy=True).numpy()


def _walk(node, path: tuple, out: dict) -> None:
    """{joined path: host array} in the reference's leaf order: dataclass
    fields in order, dict keys sorted, lists stacked."""
    if node is None:
        return
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _walk(getattr(node, f.name), path + (f.name,), out)
    elif isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        _walk(stacked_numpy(node, _host), path, out)
    else:
        out["/".join(path)] = node if isinstance(node, np.ndarray) else _host(node)


def _flatten(tree) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    _walk(tree, (), out)
    return out


def save(
    ckpt_dir: str, step: int, state: Any, *, extra: Optional[dict] = None,
    async_: bool = False,
) -> threading.Thread | None:
    """Write checkpoint atomically; optionally in a background thread (on
    one rank only: a sharded save over several ranks writes synchronously
    and ends at a barrier)."""
    arrays = _flatten(state)           # host copies happen synchronously (consistent cut)
    many = _sharded(state) and dist.is_initialized() and dist.get_world_size() > 1
    writer = not many or dist.get_rank() == 0

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = dict(step=step, n_leaves=len(arrays), extra=extra or {})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if many:
        if writer:
            _write()
        dist.barrier()
        return None
    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _sharded(state) -> bool:
    return any(isinstance(x, DTensor) for x in _tensor_leaves(state))


def _tensor_leaves(node) -> list:
    if node is None:
        return []
    if dataclasses.is_dataclass(node):
        return [x for f in dataclasses.fields(node) for x in _tensor_leaves(getattr(node, f.name))]
    return leaves(node)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`arr` as a tensor of `like`'s dtype on its device; `|V2` items are
    bfloat16 bytes."""
    arr = np.array(arr, order="C")        # a 0-d leaf stays 0-d
    if arr.dtype == _BF16_BYTES:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(device=like.device, dtype=like.dtype, copy=True)
    return t.requires_grad_(like.requires_grad) if t.is_floating_point() else t


def _restore(node, path: tuple, arrays: dict, index: tuple = (), dims: tuple = (),
             sh=None):
    if node is None:
        return None
    if dataclasses.is_dataclass(node):
        return type(node)(**{f.name: _restore(getattr(node, f.name), path + (f.name,),
                                              arrays, index, dims,
                                              None if sh is None else getattr(sh, f.name))
                             for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        return {k: _restore(v, path + (str(k),), arrays, index, dims,
                            None if sh is None else sh[k]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_restore(x, path, arrays, index + (i,), dims + (len(node),),
                                   None if sh is None else sh[i])
                          for i, x in enumerate(node))
    key = "/".join(path)
    arr = arrays[key]
    assert arr.shape == dims + tuple(node.shape), (key, arr.shape, dims + tuple(node.shape))
    t = _tensor(arr[index], node)
    if sh is None:
        return t
    from repro_torch.launch.sharding import place

    return place(t, sh)


def restore(ckpt_dir: str, step: int, template: Any, shardings: Any | None = None
            ) -> tuple[Any, dict]:
    """Restore into the structure of `template` (new tensors of each
    template leaf's dtype, device and requires_grad), each leaf placed with
    `shardings` (the same structure, `launch/sharding.Sharding` leaves: a
    DTensor of the target mesh's layout) or, with None, a plain tensor.
    Returns (state, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return _restore(template, (), arrays, sh=shardings), manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest `keep` checkpoints (rank 0's work on a world of
    several ranks)."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
