"""Shared transformer layers: RMSNorm, RoPE, GQA attention (online-softmax
chunked for long sequences), SwiGLU/GELU MLPs, embeddings.

The counterpart of `repro/models/layers.py`.  All functions are plain
functions on tensors (params in, activations out), so the same code path
serves a full sequence (train logits, prefill with cache emit) and decode
(one position, cache read/write).  Attention is computed as the reference
computes it -- its einsums, a float32 softmax, chunked where it chunks --
and not by `scaled_dot_product_attention`.  The reference's sharding hints
(`models/partition.py`) are no-ops without a mesh and are left out.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`'s operations, x * (1 / (1 + exp(-x))), each rounded to
    x's dtype (`F.silu` rounds once: in bfloat16 the two differ by an ulp on
    ~40 % of the values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or broadcastable)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)          # [half]
    angles = positions[..., None].float() * freqs                          # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _soft_cap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    softcap: float = 0.0, q_offset: int = 0, kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Reference attention (materialises [B, H, Sq, Sk] scores).

    q: [B, Sq, H, D];  k, v: [B, Sk, KV, D];  GQA via head grouping.
    q_offset: position of q[0] within the kv axis (decode: current step).
    kv_len: valid kv prefix length (decode with a padded cache).
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = _soft_cap(scores * (1.0 / math.sqrt(d)), softcap)
    kv_pos = torch.arange(sk, device=q.device)
    neg = torch.finfo(torch.float32).min
    if causal:
        q_pos = torch.arange(sq, device=q.device) + q_offset
        scores = scores.masked_fill(~(q_pos[:, None] >= kv_pos[None, :]), neg)
    if kv_len is not None:
        scores = scores.masked_fill(~(kv_pos < kv_len), neg)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def chunked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    softcap: float = 0.0, q_chunk: int = 512, k_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention: O(chunk^2) live memory for arbitrarily long S.

    The reference's two nested scans (query chunks, then kv chunks carrying
    the running max, denominator and accumulator) as two Python loops.
    Exact (tested against full_attention).
    """
    b, s, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    if s % q_chunk or sk % k_chunk:
        # the reference's path for ragged sizes (small models / tests)
        return full_attention(q, k, v, causal=causal, softcap=softcap)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s // q_chunk, q_chunk, kv, g, d).float()
    ks = k.reshape(b, sk // k_chunk, k_chunk, kv, d).float()
    vs = v.reshape(b, sk // k_chunk, k_chunk, kv, d).float()
    q_iota = torch.arange(q_chunk, device=q.device)
    k_iota = torch.arange(k_chunk, device=q.device)
    neg = -1e30
    outs = []
    for qi in range(s // q_chunk):
        qc = qg[:, qi]                                       # [b, Cq, kv, g, d]
        m = torch.full((b, kv, g, q_chunk), neg, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv, g, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv, g, q_chunk, d), dtype=torch.float32, device=q.device)
        for kj in range(sk // k_chunk):
            scores = torch.einsum("bqkgd,bskd->bkgqs", qc, ks[:, kj]) * scale
            scores = _soft_cap(scores, softcap)
            if causal:
                qpos = qi * q_chunk + q_iota
                kpos = kj * k_chunk + k_iota
                scores = scores.masked_fill(~(qpos[:, None] >= kpos[None, :]), neg)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vs[:, kj])
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)      # [b, kv, g, Cq, d]
        outs.append(out.permute(0, 3, 1, 2, 4))               # [b, Cq, kv, g, d]
    return torch.cat(outs, dim=1).reshape(b, s, h, d).to(q.dtype)


def attention_block(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    cache: Optional[dict] = None,
    cache_pos: Optional[int] = None,
    use_rope: bool = True,
    kv_override: Optional[tuple] = None,
    long_chunked: bool = True,
):
    """GQA attention with optional KV cache.

    cache: {"k": [B, cap, KV, D], "v": ...} -- when given with cache_pos, the
    new K/V rows are written at cache_pos IN PLACE (the reference updates it
    functionally under donation; its start is clamped so the rows fit, as
    `dynamic_update_slice` clamps); attention runs over the cache prefix.
    Returns (out [B, S, Dm], the cache or the emitted (k, v)).
    kv_override: (k, v) cross-attention memory (encoder output), bypasses
    K/V projection caching.  causal=False: bidirectional (the encoder);
    use_rope=False: no rotary positions; long_chunked=False: full attention
    at any length (no caller sets it, here or in the reference).
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dk->bsk", x, p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    if kv_override is None:
        k = torch.einsum("bsd,dk->bsk", x, p["wk"].to(x.dtype)).reshape(b, s, kvh, hd)
        v = torch.einsum("bsd,dk->bsk", x, p["wv"].to(x.dtype)).reshape(b, s, kvh, hd)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(h, hd).to(x.dtype)
            k = k + p["bk"].reshape(kvh, hd).to(x.dtype)
            v = v + p["bv"].reshape(kvh, hd).to(x.dtype)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(h, hd).to(x.dtype)

    if cache is not None:
        # decode / cached attention: write new kv at cache_pos, attend prefix
        ck, cv = cache["k"], cache["v"]
        start = max(0, min(int(cache_pos), ck.shape[1] - s))
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        out = full_attention(q, ck, cv, causal=False, softcap=cfg.attn_logit_softcap,
                             kv_len=int(cache_pos) + s)
        emitted = cache
    elif kv_override is not None:
        # cross-attention: chunk long sequences too
        if long_chunked and s >= 2048 and k.shape[1] >= 2048:
            out = chunked_attention(q, k, v, causal=False, softcap=cfg.attn_logit_softcap)
        else:
            out = full_attention(q, k, v, causal=False, softcap=cfg.attn_logit_softcap)
        emitted = None
    else:
        if long_chunked and s >= 2048:
            out = chunked_attention(q, k, v, causal=causal, softcap=cfg.attn_logit_softcap)
        else:
            out = full_attention(q, k, v, causal=causal, softcap=cfg.attn_logit_softcap)
        emitted = (k, v)
    out = out.reshape(b, s, h * hd)
    return torch.einsum("bsk,kd->bsd", out, p["wo"].to(x.dtype)), emitted


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
        up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
        return torch.einsum("bsf,fd->bsd", silu(gate) * up, p["w_down"].to(x.dtype))
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    # jax.nn.gelu approximates with tanh by default
    return torch.einsum("bsf,fd->bsd", F.gelu(up, approximate="tanh"),
                        p["w_down"].to(x.dtype))


# ---------------------------------------------------------------------------
# Parameter init helpers.  The port draws from its own torch.Generator, so
# its random weights are not the reference's; parity tests carry the
# reference's weights across (transformer.params_from_numpy).
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
            * scale).to(dtype)


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, out_scale: float) -> dict:
    h, kvh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": dense_init(gen, (d, h * hd), s, dtype),
        "wk": dense_init(gen, (d, kvh * hd), s, dtype),
        "wv": dense_init(gen, (d, kvh * hd), s, dtype),
        "wo": dense_init(gen, (h * hd, d), out_scale / math.sqrt(h * hd), dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, out_scale: float,
             d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    s = 1.0 / math.sqrt(d)
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, f), s, dtype),
            "w_up": dense_init(gen, (d, f), s, dtype),
            "w_down": dense_init(gen, (f, d), out_scale / math.sqrt(f), dtype),
        }
    return {
        "w_up": dense_init(gen, (d, f), s, dtype),
        "w_down": dense_init(gen, (f, d), out_scale / math.sqrt(f), dtype),
    }
