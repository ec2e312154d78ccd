"""Shared transformer layers: RMSNorm, RoPE, GQA attention (online-softmax
chunked for long sequences), SwiGLU/GELU MLPs, embeddings.

The counterpart of `repro/models/layers.py`.  All functions are plain
functions on tensors (params in, activations out), so the same code path
serves a full sequence (train logits, prefill with cache emit) and decode
(one position, cache read/write).  Attention is computed as the reference
computes it -- its einsums, a float32 softmax, chunked where it chunks --
and not by `scaled_dot_product_attention`.  The reference's sharding hints
(`models/partition.hint`) stand where it puts them; without an ambient mesh
each returns its input itself.

Training: `remat_wrap` is the reference's activation checkpointing on
`torch.utils.checkpoint`, and `gather_rows` is an indexed gather whose
gradient adds its duplicate rows in a fixed order.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.partition import hint, per_head_shards

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


# "dots": the matmul outputs a selective checkpoint saves (the reference's
# `dots_with_no_batch_dims_saveable`); everything else is recomputed
_DOT_OPS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default]


def remat_wrap(body: Callable, remat) -> Callable:
    """Activation checkpointing of a block, as the reference's `remat_wrap`.

    remat: False / None / "none" -> no checkpointing; "dots" -> save the
    matmul outputs, recompute the rest; True / "nothing" -> save nothing,
    recompute the block in the backward.  Recomputation runs the same
    operations on the same inputs, so it changes no value.  Where autograd
    is off (serving) the body runs as it is.
    """
    if remat in (False, None, "none"):
        return body
    if remat not in (True, "nothing", "dots"):
        raise ValueError(f"remat must be True, False, 'nothing', 'dots' or 'none', got "
                         f"{remat!r}")
    kw = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = lambda: _ckpt.create_selective_checkpoint_contexts(_DOT_OPS)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        again = partition.snapshot()      # the recompute resolves hints as the forward did

        def rerun(*a):
            with again():
                return body(*a)

        return _ckpt.checkpoint(rerun, *args, **kw)

    return wrapped


@contextlib.contextmanager
def _deterministic_algorithms():
    """`torch.use_deterministic_algorithms(True)` for the block, the previous
    setting restored after it."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


class _GatherRows(torch.autograd.Function):
    """table[index...] whose backward adds the rows of repeated indices in a
    fixed order: `index_put_(accumulate=True)` under deterministic
    algorithms, for that call only (PyTorch promises a fixed order only
    there; a switch for the whole step would refuse the SSM's float cumsum
    on the card).  A (replicated) DTensor table gets its gradient added on
    every replica in the same order (`partition.on_replicas`: DTensor has no
    `index_put_` rule in every release)."""

    @staticmethod
    def forward(ctx, table, *index):
        ctx.save_for_backward(*index)
        ctx.table_shape = table.shape
        return table[index]

    @staticmethod
    def backward(ctx, grad):
        shape, index = ctx.table_shape, ctx.saved_tensors

        def add_rows(grad, *index):
            out = torch.zeros(shape, dtype=grad.dtype, device=grad.device)
            with _deterministic_algorithms():
                out.index_put_(index, grad, accumulate=True)
            return out

        return (partition.on_replicas(add_rows, grad, *index),) + (None,) * len(index)


def gather_rows(table: torch.Tensor, *index: torch.Tensor) -> torch.Tensor:
    """`table[index]` (int64 index tensors) with a deterministic gradient.
    A sharded table is gathered first (`partition.replicate_operand`, the
    FSDP gather of a weight before its use; DTensor's `aten.index` rule
    takes no table sharded on the indexed dim in every release), and its
    gradient goes back to the table's placements through that gather's
    backward."""
    return _GatherRows.apply(partition.replicate_operand(table), *index)


def repeat_groups(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """`x.repeat_interleave(n, dim)` as a broadcast and a reshape: the same
    values, and a backward that sums the copies (repeat_interleave's adds
    them with atomics on the card)."""
    dim = dim % x.dim()
    shape = tuple(x.shape)
    y = x.unsqueeze(dim + 1).expand(shape[:dim + 1] + (n,) + shape[dim + 1:])
    return y.reshape(shape[:dim] + (shape[dim] * n,) + shape[dim + 1:])


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
    Exact (tested against full_attention).  Each query chunk is
    checkpointed, as the reference's `@jax.checkpoint q_step`: without it the
    backward keeps every float32 score tile, the whole S^2 matrix.
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

    def q_step(qc, ks, vs, qi: int):
        """One query chunk [b, Cq, kv, g, d] against every kv chunk."""
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
        return out.permute(0, 3, 1, 2, 4)                     # [b, Cq, kv, g, d]

    step = remat_wrap(q_step, True)
    outs = [step(qg[:, qi], ks, vs, qi) for qi in range(s // q_chunk)]
    return torch.cat(outs, dim=1).reshape(b, s, h, d).to(q.dtype)


def split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> [B, S, n, hd] (a sharded feature dim first brought
    to shards of whole heads, `partition.split_ready`)."""
    b, s, _ = x.shape
    return partition.split_ready(x, -1, n).reshape(b, s, n, hd)


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
    x = partition.gather_sequence(x)
    q = split_heads(torch.einsum("bsd,dk->bsk", x, p["wq"].to(x.dtype)), h, hd)
    q = hint(q, "dp", None, "tp", None)
    if kv_override is None:
        k = split_heads(torch.einsum("bsd,dk->bsk", x, p["wk"].to(x.dtype)), kvh, hd)
        v = split_heads(torch.einsum("bsd,dk->bsk", x, p["wv"].to(x.dtype)), kvh, hd)
        k = hint(k, "dp", None, "tp", None)
        v = hint(v, "dp", None, "tp", None)
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
        out = per_head_shards(full_attention, q, ck, cv, causal=False,
                              softcap=cfg.attn_logit_softcap, kv_len=int(cache_pos) + s)
        emitted = cache
    elif kv_override is not None:
        # cross-attention: chunk long sequences too
        core = (chunked_attention if long_chunked and s >= 2048 and k.shape[1] >= 2048
                else full_attention)
        out = per_head_shards(core, q, k, v, causal=False, softcap=cfg.attn_logit_softcap)
        emitted = None
    else:
        core = chunked_attention if long_chunked and s >= 2048 else full_attention
        out = per_head_shards(core, q, k, v, causal=causal, softcap=cfg.attn_logit_softcap)
        emitted = (k, v)
    out = partition.keep_grad_layout(out.reshape(b, s, h * hd))
    proj = torch.einsum("bsk,kd->bsd", out, p["wo"].to(x.dtype))
    return hint(proj, "dp", None, None), emitted


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    x = partition.gather_sequence(x)
    if cfg.mlp_type == "swiglu":
        gate = hint(torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype)), "dp", None, "tp")
        up = hint(torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype)), "dp", None, "tp")
        out = torch.einsum("bsf,fd->bsd", silu(gate) * up, p["w_down"].to(x.dtype))
        return hint(out, "dp", None, None)
    up = hint(torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype)), "dp", None, "tp")
    # jax.nn.gelu approximates with tanh by default
    out = torch.einsum("bsf,fd->bsd", F.gelu(up, approximate="tanh"), p["w_down"].to(x.dtype))
    return hint(out, "dp", None, None)


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
