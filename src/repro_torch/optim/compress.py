"""Error-feedback int8 gradient compression: the counterpart of
`repro/optim/compress.py`.

Gradients are quantised to int8 with a per-tensor scale before the
data-parallel reduction; the quantisation residual is fed back into the
next step so the compression error does not accumulate.  On one card
there is no reduction, so `apply` is the round trip the optimizer sees.

The scale is the reference's: one per leaf of its tree, where a leaf
stacks every layer ([L, ...]).  The port keeps one tensor a layer, so
`apply` takes one scale over the layers of a list, the largest |x| of any.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaf_keys, leaves, map_tree, unflatten


def init_error(params):
    return map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _scale(xs: list) -> torch.Tensor:
    top = torch.max(torch.stack([torch.max(torch.abs(x)) for x in xs]))
    return torch.clamp(top, min=1e-12) / 127.0


def _quantize(x: torch.Tensor, scale: torch.Tensor):
    """(q, new error): q = x / scale rounded half to even, as `jnp.round`."""
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, x - q.to(torch.float32) * scale


def compress_tensor(g: torch.Tensor, err: torch.Tensor):
    """Returns (quantised int8, scale, new_error).  deq = q * scale."""
    x = g.to(torch.float32) + err
    scale = _scale([x])
    q, new_err = _quantize(x, scale)
    return q, scale, new_err


def apply(grads, errors):
    """Compress + decompress every leaf with error feedback, one scale for
    the layers of each stacked leaf of the reference.  Returns
    (dequantised grads, each in its gradient's dtype, new error state)."""
    flat_g, flat_e = leaves(grads), leaves(errors)
    groups: dict[tuple, list[int]] = {}
    for i, key in enumerate(leaf_keys(grads)):
        groups.setdefault(key, []).append(i)
    deqs, errs = [None] * len(flat_g), [None] * len(flat_g)
    for idx in groups.values():
        xs = [flat_g[i].to(torch.float32) + flat_e[i] for i in idx]
        scale = _scale(xs)
        for i, x in zip(idx, xs):
            q, errs[i] = _quantize(x, scale)
            deqs[i] = (q.to(torch.float32) * scale).to(flat_g[i].dtype)
    return unflatten(grads, deqs), unflatten(grads, errs)
