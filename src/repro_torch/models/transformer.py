"""Dense / MoE decoder-only transformer (phi3, mistral-large, qwen2.5,
smollm, grok-1, qwen2-moe, and the internvl2 LLM backbone).

The counterpart of `repro/models/transformer.py`.  The reference stacks the
block parameters on a leading layer axis and scans over it; the port keeps
one parameter dict per block in a list and runs the blocks in a Python
loop.  The same block code drives a full sequence (train logits, prefill
emitting the KV cache) and decode (cache read/write at a position).

Parameters are a dict: {"embed", "blocks": [per-block dict], "final_ln",
"lm_head" (untied heads only)}.  `params_from_numpy` carries the
reference's parameter pytree across, unstacking its layer axis.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _generator(key: Any, device: DeviceLike) -> torch.Generator:
    """`key`: a torch.Generator (used as it is) or an int seed drawn on
    `device` (None: the card)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=resolve_device(device)).manual_seed(int(key))


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "attn": L.init_attention(gen, cfg, dtype, out_scale),
    }
    if cfg.family == "moe":
        p["moe"] = M.init_moe(gen, cfg, dtype, out_scale)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, dtype, out_scale)
    return p


def init_params(cfg: ModelConfig, key: Any = 0, device: DeviceLike = None) -> dict:
    """Random weights with the reference's shapes and scales, drawn from the
    port's own torch.Generator (so not the reference's values)."""
    gen = _generator(key, device)
    dtype = L.dtype_of(cfg.param_dtype)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "blocks": [init_block(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_ln": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            gen, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), dtype)
    return params


def tensors_from_numpy(node, device: torch.device, index: tuple = ()):
    """A nested dict of numpy arrays -> the same dict of tensors on
    `device`, each leaf indexed by `index` first (one layer of a stacked
    layer axis)."""
    if isinstance(node, dict):
        return {k: tensors_from_numpy(v, device, index) for k, v in node.items()}
    arr = np.asarray(node)[index]
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def params_from_numpy(cfg: ModelConfig, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's `init_params` pytree (leaves as numpy arrays) -> the
    port's parameters on `device`, the stacked block axis unstacked."""
    dev = resolve_device(device)
    params = {k: tensors_from_numpy(v, dev) for k, v in tree.items() if k != "blocks"}
    params["blocks"] = [tensors_from_numpy(tree["blocks"], dev, (i,))
                        for i in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _block_apply(h, lp, cfg: ModelConfig, positions, *, cache_slice=None, cache_pos=None):
    """One transformer block.  Returns (h, emitted, aux): emitted is (k, v)
    in full-sequence mode or the written cache slice in decode mode."""
    a, emitted = L.attention_block(
        L.rms_norm(h, lp["ln1"], cfg.rms_eps), lp["attn"], cfg, positions,
        cache=cache_slice, cache_pos=cache_pos,
    )
    h = h + a
    hn = L.rms_norm(h, lp["ln2"], cfg.rms_eps)
    if cfg.family == "moe":
        m, aux = M.moe_ffn(hn, lp["moe"], cfg)
    else:
        m, aux = L.mlp_block(hn, lp["mlp"], cfg), torch.zeros((), device=h.device)
    return h + m, emitted, aux


def _embed(cfg: ModelConfig, params, tokens, embeds_prefix=None):
    cd = L.cdtype(cfg)
    h = params["embed"][tokens.long()].to(cd)
    if embeds_prefix is not None:
        h = torch.cat([embeds_prefix.to(cd), h], dim=1)
    return h


def _head(cfg: ModelConfig, params, h):
    h = L.rms_norm(h, params["final_ln"], cfg.rms_eps)
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    return torch.einsum("bsd,dv->bsv", h, w.to(h.dtype)).float()


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def forward(
    cfg: ModelConfig, params, tokens: torch.Tensor, *,
    embeds_prefix: Optional[torch.Tensor] = None, emit_kv: bool = False,
):
    """tokens [B, S] (+ optional prefix embeddings, e.g. image patches) ->
    (logits [B, S_total, V] float32, aux_loss, emitted kv or None).

    The emitted kv is (k, v), each stacked [L, B, S, KV, hd] as the
    reference's scan stacks them.  The reference's `remat` and `use_tp`
    switches belong to training and sharding, which are not ported."""
    with torch.no_grad():
        h = _embed(cfg, params, tokens, embeds_prefix)
        b, s, _ = h.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
        aux = torch.zeros((), device=h.device)
        ks, vs = [], []
        for lp in params["blocks"]:
            h, emitted, aux_l = _block_apply(h, lp, cfg, positions)
            aux = aux + aux_l
            if emit_kv:
                ks.append(emitted[0])
                vs.append(emitted[1])
        kv = (torch.stack(ks), torch.stack(vs)) if emit_kv else None
        return _head(cfg, params, h), aux, kv


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cap: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (cfg.n_layers, batch, cap, kvh, hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(cfg: ModelConfig, params, tokens, *, cache_cap: Optional[int] = None,
            embeds_prefix: Optional[torch.Tensor] = None):
    """Full-sequence forward emitting the KV cache.  Returns (last_logits
    [B, V], cache, pos): the cache is bfloat16 whatever the compute dtype,
    as the reference casts it."""
    logits, _, (ks, vs) = forward(cfg, params, tokens, embeds_prefix=embeds_prefix,
                                  emit_kv=True)
    s = ks.shape[2]
    cap = cache_cap or s
    cache = init_cache(cfg, ks.shape[1], max(cap, s), device=ks.device)
    cache["k"][:, :, :s] = ks.to(torch.bfloat16)
    cache["v"][:, :, :s] = vs.to(torch.bfloat16)
    return logits[:, -1, :], cache, s


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: dict, pos: int):
    """One decode step.  token [B, 1] int; pos: the current length.

    Returns (logits [B, V], cache).  The cache is written in place (the
    reference updates it functionally and donates it under jit)."""
    with torch.no_grad():
        h = _embed(cfg, params, token)
        b = h.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=h.device)
        for i, lp in enumerate(params["blocks"]):
            h, _, _ = _block_apply(
                h, lp, cfg, positions,
                cache_slice={"k": cache["k"][i], "v": cache["v"][i]}, cache_pos=int(pos))
        return _head(cfg, params, h)[:, 0, :], cache
