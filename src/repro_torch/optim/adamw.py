"""AdamW: the counterpart of `repro/optim/adamw.py`, name for name.

Decoupled weight decay, bias-corrected moments, global-norm clipping, the
reference's operations in its order in float32.  Moments can be kept in
bfloat16 (`moment_dtype`).  The reference returns new trees; the port
updates the parameters and moments in place under `torch.no_grad()` (a
functional copy would double parameter memory at full size) and returns
the same objects.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    step: torch.Tensor          # 0-d int32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


def init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    mdt = dtype_of(cfg.moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)  # noqa: E731  (a DTensor's layout kept)
    device = leaves(params)[0].device
    return AdamWState(m=map_tree(zeros, params), v=map_tree(zeros, params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return map_tree(lambda g: (g * scale).to(g.dtype), grads), norm


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           lr: Optional[torch.Tensor] = None):
    """One step.  Returns (params, state, grad_norm): `params` and the
    state's moments and step updated in place."""
    lr = cfg.lr if lr is None else lr
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    state.step += 1
    step = state.step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    f32 = torch.float32

    def upd(p, g, m, v):
        g32 = g.to(f32)
        m32 = m.to(f32) * cfg.b1 + g32 * (1.0 - cfg.b1)
        v32 = v.to(f32) * cfg.b2 + g32 * g32 * (1.0 - cfg.b2)
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(f32)
        p.copy_(p.to(f32) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v),
                          strict=True):
        upd(p, g, m, v)
    return params, state, gnorm
