"""Zamba2-style hybrid: a Mamba2 backbone with a single weight-SHARED
attention+MLP block applied every `shared_attn_period` layers, specialised
per invocation by low-rank (LoRA) adapters on the attention projections
(zamba2-2.7b: 54 mamba layers, shared block with 32 heads / d_ff 10240).

The counterpart of `repro/models/hybrid.py`, name for name.  Layer schedule
(n_inv = n_layers / period groups):

    for inv in range(n_inv):
        h = shared_attention_block(h, shared_params, lora[inv])   # full attn
        for lp in mamba[inv]: h = mamba_block(h, lp)              # SSD

The reference scans both levels over stacked parameters; the port keeps
`mamba` as a list of n_inv lists of `period` block dicts and `lora` as a
list of n_inv dicts.  Decode keeps one KV cache segment per invocation
plus per-layer SSM states, and writes them in place.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

LORA_RANK = 64


def n_invocations(cfg: ModelConfig) -> int:
    if not (cfg.shared_attn_period and cfg.n_layers % cfg.shared_attn_period == 0):
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"shared_attn_period {cfg.shared_attn_period}")
    return cfg.n_layers // cfg.shared_attn_period


def init_params(cfg: ModelConfig, key: Any = 0, device: DeviceLike = None) -> dict:
    """Random weights with the reference's shapes and scales, drawn from the
    port's own torch.Generator (so not the reference's values)."""
    gen = T._generator(key, device)
    dtype = L.dtype_of(cfg.param_dtype)
    dev = gen.device
    n_inv, period = n_invocations(cfg), cfg.shared_attn_period
    mamba = [[S.init_mamba_block(gen, cfg, dtype) for _ in range(period)]
             for _ in range(n_inv)]
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    shared = {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "attn": L.init_attention(gen, cfg, dtype, out_scale),
        "mlp": L.init_mlp(gen, cfg, dtype, out_scale),
    }
    d, h, hd, r = cfg.d_model, cfg.n_heads, cfg.head_dim, LORA_RANK
    lora = [{"a_q": L.dense_init(gen, (d, r), 1.0 / math.sqrt(d), dtype),
             # zero-init: the shared block is exact at init
             "b_q": torch.zeros((r, h * hd), dtype=dtype, device=dev)}
            for _ in range(n_inv)]
    params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "mamba": mamba,
        "shared": shared,
        "lora": lora,
        "final_ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, cfg.vocab), 1.0 / math.sqrt(d), dtype)
    return params


def params_from_numpy(cfg: ModelConfig, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's `init_params` pytree (numpy leaves) -> the port's
    parameters on `device`: `mamba` [n_inv, period, ...] unstacked into
    lists of lists, `lora` [n_inv, ...] into a list."""
    dev = resolve_device(device)
    n_inv, period = n_invocations(cfg), cfg.shared_attn_period
    params = {k: T.tensors_from_numpy(v, dev) for k, v in tree.items()
              if k not in ("mamba", "lora")}
    params["mamba"] = [[T.tensors_from_numpy(tree["mamba"], dev, (i, j))
                        for j in range(period)] for i in range(n_inv)]
    params["lora"] = [T.tensors_from_numpy(tree["lora"], dev, (i,)) for i in range(n_inv)]
    return params


def _shared_attn(cfg, shared, lora_inv, h, positions, cache=None, cache_pos=None):
    """Shared attention + MLP block with per-invocation LoRA on W_q."""
    xn = L.rms_norm(h, shared["ln1"], cfg.rms_eps)
    # LoRA delta on q projection: x @ (Wq + Aq Bq)
    attn_p = dict(shared["attn"])
    attn_p["wq"] = attn_p["wq"] + torch.einsum(
        "dr,rk->dk", lora_inv["a_q"].float(), lora_inv["b_q"].float()).to(attn_p["wq"].dtype)
    a, emitted = L.attention_block(
        xn, attn_p, cfg, positions, causal=True, cache=cache, cache_pos=cache_pos)
    h = h + a
    h = h + L.mlp_block(L.rms_norm(h, shared["ln2"], cfg.rms_eps), shared["mlp"], cfg)
    return h, emitted


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *, emit_state: bool = False):
    """tokens [B, S] -> (logits [B, S, V] float32, aux 0, emitted): with
    `emit_state`, ((k, v) each [n_inv, B, S, KV, hd], (conv tails, SSM
    states) each [n_inv, period, B, ...]), else None."""
    with torch.no_grad():
        h = T._embed(cfg, params, tokens)
        b, s, _ = h.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
        ks, vs, tails, states = [], [], [], []
        for lora_inv, group in zip(params["lora"], params["mamba"], strict=True):
            h, (k, v) = _shared_attn(cfg, params["shared"], lora_inv, h, positions)
            group_states = []
            for lp in group:
                h, state = S.mamba_block(h, lp, cfg)
                if emit_state:
                    group_states.append(state)
            if emit_state:
                ks.append(k)
                vs.append(v)
                tails.append(torch.stack([t for t, _ in group_states]))
                states.append(torch.stack([st for _, st in group_states]))
        emitted = None
        if emit_state:
            emitted = ((torch.stack(ks), torch.stack(vs)),
                       (torch.stack(tails), torch.stack(states)))
        return T._head(cfg, params, h), torch.zeros((), device=h.device), emitted


def init_cache(cfg: ModelConfig, batch: int, cap: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> dict:
    n_inv, period = n_invocations(cfg), cfg.shared_attn_period
    dev = resolve_device(device)
    ssm = S.init_cache(cfg, batch, device=dev)
    kv_shape = (n_inv, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {
        "attn_k": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "attn_v": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "conv": ssm["conv"].reshape((n_inv, period) + ssm["conv"].shape[1:]),
        "ssm": ssm["ssm"].reshape((n_inv, period) + ssm["ssm"].shape[1:]),
    }


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            cache_cap: Optional[int] = None):
    """Returns (last_logits [B, V], cache, pos): attn_k / attn_v bfloat16
    [n_inv, B, cap, KV, hd], conv tails in the compute dtype and float32
    SSM states, each [n_inv, period, B, ...]."""
    logits, _, ((ks, vs), (conv_tails, ssm_states)) = forward(cfg, params, tokens,
                                                               emit_state=True)
    s = ks.shape[2]
    cap = max(cache_cap or s, s)
    shape = ks.shape[:2] + (cap,) + ks.shape[3:]
    cache = {"attn_k": torch.zeros(shape, dtype=torch.bfloat16, device=ks.device),
             "attn_v": torch.zeros(shape, dtype=torch.bfloat16, device=ks.device),
             "conv": conv_tails, "ssm": ssm_states}
    cache["attn_k"][:, :, :s] = ks.to(torch.bfloat16)
    cache["attn_v"][:, :, :s] = vs.to(torch.bfloat16)
    return logits[:, -1, :], cache, s


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: dict, pos: int):
    """One decode step.  token [B, 1] int.  Returns (logits [B, V], cache),
    every cache entry written in place through views of its invocation."""
    with torch.no_grad():
        h = T._embed(cfg, params, token)
        b = h.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=h.device)
        for i, (lora_inv, group) in enumerate(zip(params["lora"], params["mamba"],
                                                  strict=True)):
            h, _ = _shared_attn(cfg, params["shared"], lora_inv, h, positions,
                                cache={"k": cache["attn_k"][i], "v": cache["attn_v"][i]},
                                cache_pos=int(pos))
            conv_g, ssm_g = cache["conv"][i], cache["ssm"][i]
            for j, lp in enumerate(group):
                h, conv, state = S.mamba_block_decode(h, lp, cfg, conv_g[j], ssm_g[j])
                conv_g[j] = conv
                ssm_g[j] = state
        return T._head(cfg, params, h)[:, 0, :], cache
