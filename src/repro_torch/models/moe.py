"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-bounded
sort-free dispatch (qwen2-moe: 60 routed top-4 + shared experts; grok-1: 8
routed top-2).

The counterpart of `repro/models/moe.py`.  Dispatch is the gather/scatter
formulation: tokens are placed into [E, C] expert buffers at their
cumulative position, each expert runs a dense SwiGLU on its buffer, and
results are combined back with routing weights.  Overflow slots beyond
capacity C = ceil(T * top_k / E * capacity_factor) are dropped (token-choice
behaviour); the router carries the Switch load-balance auxiliary loss.

The reference drops out-of-capacity slots through scatters with
`mode="drop"`; PyTorch raises on an out-of-range index, so the slots that
fit are selected by an explicit mask first.
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


# The routing record: None, or a list that each moe_ffn call appends its
# top-k expert ids to (start_routing_record / stop_routing_record).
_ROUTING: list | None = None


def start_routing_record() -> None:
    """Record the experts each moe_ffn call picks until stop_routing_record."""
    global _ROUTING
    _ROUTING = []


def stop_routing_record() -> list[torch.Tensor]:
    """The top-k expert ids [T, k] (token-major: T = B * S) of each moe_ffn
    call since start_routing_record, in call order, one a layer.  Recording
    stops."""
    global _ROUTING
    out, _ROUTING = _ROUTING or [], None
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, out_scale: float) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = 1.0 / math.sqrt(d)
    p = {
        "router": L.dense_init(gen, (d, e), s, torch.float32),   # router in fp32
        "w_gate": L.dense_init(gen, (e, d, fe), s, dtype),
        "w_up": L.dense_init(gen, (e, d, fe), s, dtype),
        "w_down": L.dense_init(gen, (e, fe, d), out_scale / math.sqrt(fe), dtype),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = L.init_mlp(gen, cfg, dtype, out_scale, d_ff=cfg.shared_expert_d_ff)
        p["shared_gate"] = L.dense_init(gen, (d, 1), s, dtype)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.experts_top_k * cfg.capacity_factor / cfg.n_experts))
    # the reference rounds up to a multiple of 512 (its mesh size) above
    # 512; kept, since it decides which slots drop
    if c > 512:
        c = -(-c // 512) * 512
    return max(c, 1)


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.experts_top_k
    c = capacity(t, cfg)
    xf = x.reshape(t, d)

    logits = torch.einsum("td,de->te", xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)                            # [T, E]
    top_p, top_e = torch.topk(probs, k, dim=-1)                      # [T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)                  # renormalise
    if _ROUTING is not None:
        _ROUTING.append(top_e)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                           # [E]
    ce = F.one_hot(top_e, e).float().sum(dim=1).mean(dim=0)
    aux = e * torch.sum(me * ce)

    # --- dispatch: position of each (token, slot) inside its expert buffer ---
    flat_e = top_e.reshape(-1)                                       # [T*k]
    onehot = F.one_hot(flat_e, e).to(torch.int32)                    # [T*k, E]
    pos_in_e = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    token_of = torch.arange(t, device=x.device).repeat_interleave(k)
    fits = pos_in_e < c                  # the reference's mode="drop" slots
    fe, fp, ft = flat_e[fits], pos_in_e[fits], token_of[fits]
    buf_tok = torch.zeros((e, c), dtype=torch.int64, device=x.device)
    buf_tok[fe, fp] = ft
    buf_used = torch.zeros((e, c), dtype=torch.bool, device=x.device)
    buf_used[fe, fp] = True
    buf_w = torch.zeros((e, c), dtype=torch.float32, device=x.device)
    buf_w[fe, fp] = top_p.reshape(-1)[fits]

    x_buf = xf[buf_tok]                                              # [E, C, D]
    x_buf = x_buf * buf_used[..., None].to(x_buf.dtype)

    # --- expert computation (dense per-expert SwiGLU) ---
    gate = torch.einsum("ecd,edf->ecf", x_buf, p["w_gate"].to(x_buf.dtype))
    up = torch.einsum("ecd,edf->ecf", x_buf, p["w_up"].to(x_buf.dtype))
    y_buf = torch.einsum("ecf,efd->ecd", L.silu(gate) * up, p["w_down"].to(x_buf.dtype))

    # --- combine: weight in buffer space, then each token sums its own k
    # slots in slot order (the reference scatter-adds the buffers back; an
    # index_add_ on the card adds in no fixed order, so greedy decoding
    # would not repeat itself) ---
    y_buf = y_buf * (buf_w * buf_used.float()).to(y_buf.dtype)[..., None]
    slot = y_buf[flat_e, pos_in_e.clamp(max=c - 1)] * fits[:, None].to(y_buf.dtype)
    y = slot.reshape(t, k, d).sum(dim=1)

    if "shared" in p:
        sh = L.mlp_block(x, p["shared"], cfg)
        sg = torch.sigmoid(torch.einsum(
            "bsd,do->bso", x.float(), p["shared_gate"].float())).to(x.dtype)
        return y.reshape(b, s, d) + sh * sg, aux
    return y.reshape(b, s, d), aux
