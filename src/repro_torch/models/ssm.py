"""Mamba2 (SSD -- state-space duality) blocks: chunked parallel scan for
train/prefill, O(1)-state recurrence for decode.  (mamba2-1.3b and the
zamba2 backbone.)

The counterpart of `repro/models/ssm.py`, name for name.  SSD recurrence
per head (state S in R^{n x p}, decay a_t <= 0):

    S_t = exp(a_t) S_{t-1} + dt_t B_t (x_t dt-weighted outer product)
    y_t = C_t . S_t + D x_t

Chunked algorithm (Dao & Gu 2024): within a chunk of length Lc the
contribution of x_j to y_i (j <= i) is C_i.B_j exp(cum_i - cum_j) dt_j x_j --
an attention-like [Lc, Lc] matmul; across chunks only the [n, p] float32
states are carried, by a Python loop over the chunks (the reference's
`lax.scan`).  Groups map to heads as `jnp.repeat` maps them: group i serves
heads i*h/g .. (i+1)*h/g - 1 (`repeat_interleave`).

Parameters: {"embed", "blocks": [per-block dict], "final_ln", "lm_head"
(untied heads only)}.  `decode_step` writes the conv and SSM states into
the cache in place and returns the same dict (the reference returns new
arrays).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads
    cch = conv_channels(cfg)
    dev = gen.device
    s = 1.0 / math.sqrt(d)
    proj_out = 2 * din + 2 * g * n + h
    f32 = torch.float32
    return {
        "ln": torch.ones((d,), dtype=dtype, device=dev),
        "in_proj": L.dense_init(gen, (d, proj_out), s, dtype),
        "conv_w": L.dense_init(gen, (cfg.conv_width, cch), 1.0 / math.sqrt(cfg.conv_width),
                               dtype),
        "conv_b": torch.zeros((cch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev)),
        "D_skip": torch.ones((h,), dtype=f32, device=dev),
        "dt_bias": torch.full((h,), math.log(math.e - 1.0), dtype=f32, device=dev),
        "norm": torch.ones((din,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, (din, d), 1.0 / math.sqrt(2 * cfg.n_layers * din), dtype),
    }


def init_params(cfg: ModelConfig, key: Any = 0, device: DeviceLike = None) -> dict:
    """Random weights with the reference's shapes and scales, drawn from the
    port's own torch.Generator (so not the reference's values)."""
    gen = T._generator(key, device)
    dtype = L.dtype_of(cfg.param_dtype)
    params = {
        "embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "blocks": [init_mamba_block(gen, cfg, dtype) for _ in range(cfg.n_layers)],
        "final_ln": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(
            gen, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), dtype)
    return params


def params_from_numpy(cfg: ModelConfig, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's `init_params` pytree (numpy leaves) -> the port's
    parameters on `device`, `blocks` unstacked."""
    return T.params_from_numpy(cfg, tree, device)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
    init_state: Optional[torch.Tensor] = None,
):
    """x [b,s,h,p]; dt [b,s,h] (post-softplus); A_log [h]; Bm/Cm [b,s,g,n].

    Returns (y [b,s,h,p] in x's dtype, final_state [b,h,n,p] float32).  The
    sequence must be a whole number of chunks, as the reference asserts.
    """
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hg = h // g
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk

    f32 = torch.float32
    a = -torch.exp(A_log.to(f32)) * dt.to(f32)                          # [b,s,h]
    xd = x.to(f32) * dt.to(f32)[..., None]                              # [b,s,h,p]

    a_c = a.reshape(b, nc, chunk, h).permute(0, 1, 3, 2)                # [b,c,h,l]
    cum = torch.cumsum(a_c, dim=-1)                                     # [b,c,h,l]
    B_c = Bm.to(f32).reshape(b, nc, chunk, g, n)
    C_c = Cm.to(f32).reshape(b, nc, chunk, g, n)
    x_c = xd.reshape(b, nc, chunk, h, p)

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xd_j
    CB = torch.einsum("bcign,bcjgn->bcgij", C_c, B_c)                   # [b,c,g,l,l]
    CB = CB.repeat_interleave(hg, dim=2)                                # [b,c,h,l,l]
    diff = cum[..., :, None] - cum[..., None, :]                        # [b,c,h,i,j]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    # mask BEFORE exp: the upper triangle has positive exponents that
    # overflow to inf, and inf * 0 is NaN
    decay = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", CB * decay, x_c)       # [b,c,l,h,p]

    # per-chunk state contribution: S_c = sum_j B_j (x)_j exp(cum_end - cum_j)
    w_end = torch.exp(cum[..., -1:] - cum)                              # [b,c,h,l]
    B_h = B_c.repeat_interleave(hg, dim=3)                              # [b,c,l,h,n]
    S_c = torch.einsum("bclhn,bclhp->bchnp", B_h * w_end.permute(0, 1, 3, 2)[..., None],
                       x_c)                                             # [b,c,h,n,p]

    chunk_decay = torch.exp(cum[..., -1])                               # [b,c,h]
    S = init_state.to(f32) if init_state is not None else torch.zeros(
        (b, h, n, p), dtype=f32, device=x.device)
    S_in = []                                                           # state entering chunk c
    for c in range(nc):
        S_in.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_c[:, c]
    S_in = torch.stack(S_in, dim=1)                                     # [b,c,h,n,p]

    # inter-chunk: y_l += C_l . (S_in decayed to l) = C_l.S_in * exp(cum_l)
    C_h = C_c.repeat_interleave(hg, dim=3)                              # [b,c,l,h,n]
    y_inter = torch.einsum("bclhn,bchnp->bclhp", C_h, S_in) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), S


def ssd_decode(
    x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
    Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor,
):
    """Single-step recurrence.  x [b,h,p]; dt [b,h]; Bm/Cm [b,g,n];
    state [b,h,n,p] -> (y [b,h,p], new_state)."""
    h = x.shape[1]
    hg = h // Bm.shape[1]
    f32 = torch.float32
    a = torch.exp(-torch.exp(A_log.to(f32)) * dt.to(f32))              # [b,h]
    B_h = Bm.to(f32).repeat_interleave(hg, dim=1)                       # [b,h,n]
    C_h = Cm.to(f32).repeat_interleave(hg, dim=1)
    xd = x.to(f32) * dt.to(f32)[..., None]                              # [b,h,p]
    new_state = state * a[..., None, None] + B_h[..., None] * xd[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp", C_h, new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """xbc [b, s, ch]; w [W, ch] depthwise causal conv; silu activation."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i:i + s, :].float() * w[i].float()
    return F.silu(out + bias.float()).to(xbc.dtype)


def conv_decode(xbc: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor):
    """xbc [b, ch] single step; conv_state [b, W-1, ch] (previous inputs).

    Returns (activated [b, ch], new_conv_state)."""
    dtype = torch.promote_types(conv_state.dtype, xbc.dtype)            # as jnp.concatenate
    window = torch.cat([conv_state.to(dtype), xbc[:, None, :].to(dtype)], dim=1)  # [b, W, ch]
    out = torch.sum(window.float() * w.float()[None], dim=1)
    y = F.silu(out + bias.float()).to(xbc.dtype)
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Block apply (full sequence / decode)
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    din, g, n = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state
    z = proj[..., :din]
    xbc = proj[..., din:2 * din + 2 * g * n]
    dt = proj[..., 2 * din + 2 * g * n:]
    return z, xbc, dt


def mamba_block(h: torch.Tensor, lp: dict, cfg: ModelConfig,
                init_state: Optional[torch.Tensor] = None):
    """Full-sequence Mamba2 block.  Returns (h_out, (conv_tail, ssm_state))."""
    b, s, _ = h.shape
    din, g, n, nh, p = (cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads,
                        cfg.ssm_head_dim)
    xn = L.rms_norm(h, lp["ln"], cfg.rms_eps)
    proj = torch.einsum("bsd,dk->bsk", xn, lp["in_proj"].to(xn.dtype))
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc = causal_conv(xbc_raw, lp["conv_w"], lp["conv_b"])
    x = xbc[..., :din].reshape(b, s, nh, p)
    Bm = xbc[..., din:din + g * n].reshape(b, s, g, n)
    Cm = xbc[..., din + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    y, state = ssd_chunked(x, dt, lp["A_log"], Bm, Cm, cfg.ssd_chunk, init_state)
    y = y + x * lp["D_skip"].float()[None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, din)
    y = L.rms_norm(y, lp["norm"], cfg.rms_eps) * L.silu(z)
    out = torch.einsum("bsk,kd->bsd", y, lp["out_proj"].to(y.dtype))
    conv_tail = xbc_raw[:, -(cfg.conv_width - 1):, :]   # pre-conv inputs for decode
    return h + out, (conv_tail, state)


def mamba_block_decode(h: torch.Tensor, lp: dict, cfg: ModelConfig,
                       conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """Single-token Mamba2 block.  h [b, 1, d].  Returns (h_out,
    new_conv_state, new_ssm_state)."""
    b = h.shape[0]
    din, g, n, nh, p = (cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads,
                        cfg.ssm_head_dim)
    xn = L.rms_norm(h, lp["ln"], cfg.rms_eps)[:, 0, :]
    proj = torch.einsum("bd,dk->bk", xn, lp["in_proj"].to(xn.dtype))
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc, new_conv = conv_decode(xbc_raw, conv_state, lp["conv_w"], lp["conv_b"])
    x = xbc[..., :din].reshape(b, nh, p)
    Bm = xbc[..., din:din + g * n].reshape(b, g, n)
    Cm = xbc[..., din + g * n:].reshape(b, g, n)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    y, new_state = ssd_decode(x, dt, lp["A_log"], Bm, Cm, ssm_state)
    y = y + x * lp["D_skip"].float()[None, :, None].to(x.dtype)
    y = y.reshape(b, din)
    y = L.rms_norm(y, lp["norm"], cfg.rms_eps) * L.silu(z)
    out = torch.einsum("bk,kd->bd", y, lp["out_proj"].to(y.dtype))
    return h + out[:, None, :], new_conv, new_state


# ---------------------------------------------------------------------------
# Model-level API (matches transformer.py's surface)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *, emit_state: bool = False):
    """tokens [B, S] -> (logits [B, S, V] float32, aux 0, states): states
    are (conv tails [L, B, W-1, ch], SSM states [L, B, h, n, p]) with
    `emit_state`, else None.  S must be a multiple of `cfg.ssd_chunk`."""
    with torch.no_grad():
        h = T._embed(cfg, params, tokens)
        tails, states = [], []
        for lp in params["blocks"]:
            h, (tail, state) = mamba_block(h, lp, cfg)
            if emit_state:
                tails.append(tail)
                states.append(state)
        emitted = (torch.stack(tails), torch.stack(states)) if emit_state else None
        return T._head(cfg, params, h), torch.zeros((), device=h.device), emitted


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_channels(cfg)),
                            dtype=dtype, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_n_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32, device=dev),
    }


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor):
    """Returns (last_logits [B, V], cache {"conv", "ssm"}, pos).  The conv
    tails are the last W-1 pre-conv inputs in the compute dtype; the SSM
    states are float32."""
    logits, _, (conv_tails, ssm_states) = forward(cfg, params, tokens, emit_state=True)
    return logits[:, -1, :], {"conv": conv_tails, "ssm": ssm_states}, tokens.shape[1]


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache: dict, pos: int):
    """One decode step.  token [B, 1] int.  Returns (logits [B, V], cache),
    the cache's states written in place."""
    with torch.no_grad():
        h = T._embed(cfg, params, token)
        for i, lp in enumerate(params["blocks"]):
            h, conv, state = mamba_block_decode(h, lp, cfg, cache["conv"][i], cache["ssm"][i])
            cache["conv"][i] = conv
            cache["ssm"][i] = state
        return T._head(cfg, params, h)[:, 0, :], cache
