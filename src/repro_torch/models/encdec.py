"""Encoder-decoder backbone (seamless-m4t-large-v2: 24L speech encoder + 24L
text decoder, d_model 1024, 16 heads, d_ff 8192, vocab 256206).

The counterpart of `repro/models/encdec.py`, name for name.  The modality
frontend is a stub, as in the reference: the batch carries precomputed frame
embeddings [B, S_src, D]; the transformer backbone -- bidirectional encoder,
causal decoder with cross-attention -- is fully built.  Parameters:
{"embed", "enc_blocks": [per-block dict], "dec_blocks": [...], "enc_ln",
"final_ln", "lm_head"}.  Decode recomputes the cross-attention K/V from the
cached encoder memory at every step, as the reference does.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    out_scale = 1.0 / math.sqrt(2 * (cfg.n_layers + cfg.n_encoder_layers))
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "ln_x": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "attn": L.init_attention(gen, cfg, dtype, out_scale),
        "xattn": L.init_attention(gen, cfg, dtype, out_scale),
        "mlp": L.init_mlp(gen, cfg, dtype, out_scale),
    }


def init_enc_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    out_scale = 1.0 / math.sqrt(2 * (cfg.n_layers + cfg.n_encoder_layers))
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "attn": L.init_attention(gen, cfg, dtype, out_scale),
        "mlp": L.init_mlp(gen, cfg, dtype, out_scale),
    }


def init_params(cfg: ModelConfig, key: Any = 0, device: DeviceLike = None) -> dict:
    """Random weights with the reference's shapes and scales, drawn from the
    port's own torch.Generator (so not the reference's values)."""
    gen = T._generator(key, device)
    dtype = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "embed": L.dense_init(gen, (cfg.vocab, d), 0.02, dtype),
        "enc_blocks": [init_enc_block(gen, cfg, dtype) for _ in range(cfg.n_encoder_layers)],
        "dec_blocks": [init_dec_block(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "enc_ln": torch.ones((d,), dtype=dtype, device=gen.device),
        "final_ln": torch.ones((d,), dtype=dtype, device=gen.device),
        "lm_head": L.dense_init(gen, (d, cfg.vocab), 1.0 / math.sqrt(d), dtype),
    }


def params_from_numpy(cfg: ModelConfig, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's `init_params` pytree (numpy leaves) -> the port's
    parameters on `device`, `enc_blocks` and `dec_blocks` unstacked."""
    dev = resolve_device(device)
    stacked = {"enc_blocks": cfg.n_encoder_layers, "dec_blocks": cfg.n_layers}
    params = {k: T.tensors_from_numpy(v, dev) for k, v in tree.items() if k not in stacked}
    for name, n in stacked.items():
        params[name] = [T.tensors_from_numpy(tree[name], dev, (i,)) for i in range(n)]
    return params


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_src, D] (stub embeddings) -> encoder memory [B, S_src, D]
    in the compute dtype."""
    with torch.no_grad():
        h = frames.to(L.cdtype(cfg))
        b, s, _ = h.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
        for lp in params["enc_blocks"]:
            a, _ = L.attention_block(L.rms_norm(h, lp["ln1"], cfg.rms_eps), lp["attn"], cfg,
                                     positions, causal=False)
            h = h + a
            h = h + L.mlp_block(L.rms_norm(h, lp["ln2"], cfg.rms_eps), lp["mlp"], cfg)
        return L.rms_norm(h, params["enc_ln"], cfg.rms_eps)


def _cross_kv(cfg, lp, memory):
    b, s, _ = memory.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = torch.einsum("bsd,dk->bsk", memory, lp["xattn"]["wk"].to(memory.dtype))
    v = torch.einsum("bsd,dk->bsk", memory, lp["xattn"]["wv"].to(memory.dtype))
    return k.reshape(b, s, kvh, hd), v.reshape(b, s, kvh, hd)


def _dec_block(cfg, lp, h, positions, memory, cache=None, cache_pos=None):
    a, emitted = L.attention_block(
        L.rms_norm(h, lp["ln1"], cfg.rms_eps), lp["attn"], cfg, positions,
        causal=True, cache=cache, cache_pos=cache_pos)
    h = h + a
    xk, xv = _cross_kv(cfg, lp, memory)
    xa, _ = L.attention_block(
        L.rms_norm(h, lp["ln_x"], cfg.rms_eps), lp["xattn"], cfg, positions,
        causal=False, kv_override=(xk, xv), use_rope=False)
    h = h + xa
    h = h + L.mlp_block(L.rms_norm(h, lp["ln2"], cfg.rms_eps), lp["mlp"], cfg)
    return h, emitted


def forward(cfg: ModelConfig, params, frames: torch.Tensor, tgt_tokens: torch.Tensor, *,
            emit_kv: bool = False):
    """Teacher-forced seq2seq forward -> (logits [B, S_tgt, V] float32, aux 0,
    (kv, memory)): kv is (k, v) each [L, B, S_tgt, KV, hd] with `emit_kv`,
    else None."""
    with torch.no_grad():
        memory = encode(cfg, params, frames)
        h = T._embed(cfg, params, tgt_tokens)
        b, s, _ = h.shape
        positions = torch.arange(s, dtype=torch.int32, device=h.device)[None].expand(b, s)
        ks, vs = [], []
        for lp in params["dec_blocks"]:
            h, (k, v) = _dec_block(cfg, lp, h, positions, memory)
            if emit_kv:
                ks.append(k)
                vs.append(v)
        kv = (torch.stack(ks), torch.stack(vs)) if emit_kv else None
        return T._head(cfg, params, h), torch.zeros((), device=h.device), (kv, memory)


def prefill(cfg: ModelConfig, params, frames: torch.Tensor, tgt_prefix: torch.Tensor, *,
            cache_cap: Optional[int] = None):
    """Returns (last_logits [B, V], cache {"k", "v", "memory"}, pos): k / v
    bfloat16 [L, B, cap, KV, hd], the memory in the compute dtype."""
    logits, _, ((ks, vs), memory) = forward(cfg, params, frames, tgt_prefix, emit_kv=True)
    s = ks.shape[2]
    cache = T.init_cache(cfg, ks.shape[1], max(cache_cap or s, s), device=ks.device)
    cache["k"][:, :, :s] = ks.to(torch.bfloat16)
    cache["v"][:, :, :s] = vs.to(torch.bfloat16)
    cache["memory"] = memory
    return logits[:, -1, :], cache, s


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: dict, pos: int):
    """One decode step.  token [B, 1] int.  Returns (logits [B, V], cache),
    the self-attention K/V written in place."""
    with torch.no_grad():
        h = T._embed(cfg, params, token)
        b = h.shape[0]
        positions = torch.full((b, 1), int(pos), dtype=torch.int32, device=h.device)
        for i, lp in enumerate(params["dec_blocks"]):
            h, _ = _dec_block(cfg, lp, h, positions, cache["memory"],
                              cache={"k": cache["k"][i], "v": cache["v"][i]},
                              cache_pos=int(pos))
        return T._head(cfg, params, h)[:, 0, :], cache
