"""Training step: loss, microbatch gradient accumulation, optional gradient
compression, AdamW.  The counterpart of `repro/train/step.py`, name for
name.

The reference jits one function per architecture; the port's step is eager
PyTorch: `torch.autograd.grad` through `train_logits` (each block
checkpointed as `TrainHParams.remat` says), then AdamW in place.  Every
gradient is deterministic: the indexed gathers add repeated rows in a
fixed order (`layers.gather_rows`), so a step repeated on the same state
and batch gives the same bits, and a resumed run equals a straight one.

Sharded (the state's leaves DTensors placed as `launch/sharding.py` says,
the batch placed by `batch_shardings`): the step runs under the state's
mesh (`mesh.use_mesh`, so the models' hints resolve against it) and
DTensor's `implicit_replication` (the plain tensors the model code makes --
positions, masks, RoPE tables -- meet the DTensors as replicated).  Each
gradient comes back from autograd as DTensor leaves it (often `Partial`
over the data axis) and is redistributed to its parameter's placements
before the global norm, clipping, compression and AdamW: the reduce-scatter
or all-reduce that GSPMD inserts in the reference.  Those all run on the
DTensors; the metrics come back replicated and are returned whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike, resolve_device, tensor_from
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import IGNORE, ModelApi
from repro_torch.optim import adamw, compress, schedule
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.AdamWState
    compress_error: Any        # None when compression is off


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    accum: int = 1                       # microbatch accumulation factor
    aux_loss_weight: float = 0.01        # MoE load-balance loss
    grad_compression: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    # True / "nothing": recompute every block; "dots": keep the matmul
    # outputs; False / "none": no checkpointing (layers.remat_wrap)
    remat: Union[bool, str] = True


def init_state(cfg: ModelConfig, api: ModelApi, key, hp: TrainHParams,
               device: DeviceLike = None) -> TrainState:
    """Fresh parameters from `key` (an int seed or a torch.Generator; the
    port's own draw, not the reference's values) on `device` (None: the
    card), requiring grad, with zeroed moments."""
    params = api.init_params(cfg, key, device=resolve_device(device))
    return state_from_params(params, hp)


def state_from_params(params, hp: TrainHParams) -> TrainState:
    """A fresh TrainState around existing parameters (e.g. the reference's
    weights carried across with `params_from_numpy`)."""
    for p in leaves(params):
        p.requires_grad_(True)
    err = compress.init_error(params) if hp.grad_compression else None
    return TrainState(params=params, opt=adamw.init(params, hp.optimizer), compress_error=err)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean CE over non-IGNORE positions.  logits [B, S, V] float32.
    Returns (ce, denom)."""
    mask = (labels != IGNORE).to(torch.float32)
    safe = torch.where(labels == IGNORE, 0, labels).long()
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # vocab-parallel logits: the gold logit as a one-hot sum over the
        # vocab shards (exact: every other term is 0); DTensor's gather
        # across a sharded vocab leaves a masked partial it cannot reduce
        gold = torch.sum(logits * F.one_hot(safe, logits.shape[-1]).to(logits.dtype), dim=-1)
    else:
        # each (row, position) reads one logit, so the backward's scatter
        # writes each gradient entry once: no order to fix
        gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    ce = (logz - gold) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(ce) / denom, denom


def make_loss_fn(cfg: ModelConfig, api: ModelApi, hp: TrainHParams):
    def loss_fn(params, batch):
        logits, aux, labels = api.train_logits(cfg, params, batch, remat=hp.remat)
        ce, ntok = cross_entropy(logits, labels)
        return ce + hp.aux_loss_weight * aux, dict(loss=ce, aux=aux, tokens=ntok)
    return loss_fn


def _on_device(batch: dict, device: torch.device) -> dict:
    """Each value a tensor on `device` (a DTensor stays as it is placed)."""
    return {k: v if isinstance(v, DTensor) else tensor_from(v).to(device)
            for k, v in batch.items()}


def _mesh_of(params):
    """The mesh the parameters are placed on, or None (plain tensors)."""
    first = leaves(params)[0]
    return first.device_mesh if isinstance(first, DTensor) else None


def _microbatch(v: torch.Tensor, a: int, b: int, use_tp: bool) -> torch.Tensor:
    """Rows a:b of a batch leaf.  A DTensor is gathered first
    (`partition.replicate_operand`: a microbatch's rows lie on some ranks
    only) and the rows placed again as `batch_spec` places a batch of their
    shape."""
    if not isinstance(v, DTensor):
        return v[a:b]
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.sharding import batch_spec

    rows = partition.replicate_operand(v)[a:b]
    axes = mesh_lib.axis_sizes(v.device_mesh)
    want = partition.placements(batch_spec(tuple(rows.shape), axes, use_tp), axes)
    return rows.redistribute(v.device_mesh, want)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient on its parameter's placements (the data-parallel
    reduction); a plain gradient as it is."""
    if isinstance(g, DTensor) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, list(p.placements))
    return g


def _whole(v: torch.Tensor) -> torch.Tensor:
    """A metric as one plain tensor (a DTensor's full value)."""
    return v.full_tensor() if isinstance(v, DTensor) else v


def make_train_step(cfg: ModelConfig, api: ModelApi, hp: TrainHParams):
    """Returns train_step(state, batch) -> (state, metrics): the state
    updated in place; metrics are 0-d tensors (loss, aux, tokens,
    grad_norm, lr, step).  `batch`: numpy arrays or tensors, moved to the
    parameters' device."""
    loss_fn = make_loss_fn(cfg, api, hp)

    def single(params, batch):
        flat = leaves(params)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        # a leaf the loss does not reach has a zero gradient, as in JAX
        return [torch.zeros_like(p) if g is None else _placed_like(g, p)
                for p, g in zip(flat, grads)], metrics

    def accumulate(params, batch):
        if hp.accum == 1:
            return single(params, batch)
        b = next(iter(batch.values())).shape[0]
        if b % hp.accum:
            raise ValueError(f"batch {b} is not a multiple of accum {hp.accum}")
        mb = b // hp.accum
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
        m_acc = None
        for i in range(hp.accum):
            g, m = single(params, {k: _microbatch(v, i * mb, (i + 1) * mb, cfg.use_tp)
                                   for k, v in batch.items()})
            g_acc = [a + x for a, x in zip(g_acc, g, strict=True)]
            m_acc = m if m_acc is None else {k: m_acc[k] + m[k] for k in m_acc}
        scale = 1.0 / hp.accum
        grads = [g * scale for g in g_acc]
        metrics = {k: v * (scale if k != "tokens" else 1.0) for k, v in m_acc.items()}
        return grads, metrics

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        device = leaves(state.params)[0].device
        with partition.sharded_scope(_mesh_of(state.params)):
            flat, metrics = accumulate(state.params, _on_device(batch, device))
            grads = unflatten(state.params, flat)
            err = state.compress_error
            if hp.grad_compression:
                grads, err = compress.apply(grads, err)
            lr = schedule.cosine_with_warmup(
                state.opt.step, peak_lr=hp.optimizer.lr,
                warmup_steps=hp.warmup_steps, total_steps=hp.total_steps,
            )
            _, opt, gnorm = adamw.update(grads, state.opt, state.params, hp.optimizer, lr)
            metrics = dict(metrics, grad_norm=gnorm, lr=lr, step=opt.step.clone())
            metrics = {k: _whole(v) for k, v in metrics.items()}
        return TrainState(params=state.params, opt=opt, compress_error=err), metrics

    return train_step

