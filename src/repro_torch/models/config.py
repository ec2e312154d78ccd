"""Model configuration shared by every assigned architecture (the counterpart
of `repro/models/config.py`, field for field; plain arithmetic)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    mlp_type: str = "swiglu"    # swiglu | gelu
    attn_logit_softcap: float = 0.0

    # --- MoE ---
    n_experts: int = 0
    experts_top_k: int = 0
    moe_d_ff: int = 0           # per routed expert
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_n_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 128

    # --- hybrid (Zamba2) ---
    shared_attn_period: int = 0  # apply the shared attention block every P layers

    # --- modality frontends (stubs: precomputed embeddings) ---
    n_patches: int = 0           # VLM image-patch prefix length
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # sharding policy of the reference (tensor parallelism for training and
    # serving).  Kept field for field; the port has no sharded model yet, so
    # nothing reads them here.
    use_tp: bool = True
    use_tp_serve: bool = True

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # the reference's layer-scan unrolling for its cost analysis; the port
    # runs its layers as a Python loop, so nothing reads it here
    scan_unroll: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        if self.qkv_bias:
            attn += hq + 2 * hkv
        if self.mlp_type == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        norms = 2 * d
        block = attn + mlp + norms

        if self.family == "ssm":
            block = self._ssm_block_params()
        total = self.n_layers * block
        if self.family == "hybrid":
            total = self.n_layers * self._ssm_block_params()
            if self.shared_attn_period:
                total += attn + mlp + 2 * d  # one shared block
        if self.family == "moe":
            routed = 3 * d * self.moe_d_ff * self.n_experts
            shared = 3 * d * self.shared_expert_d_ff if self.shared_expert_d_ff else 0
            router = d * self.n_experts
            block = attn + norms + routed + shared + router
            total = self.n_layers * block
        if self.is_encoder_decoder:
            # encoder blocks + decoder blocks with cross attention
            total = self.n_encoder_layers * block + self.n_layers * (block + attn + d)
        total += v * d                      # embeddings
        if not self.tie_embeddings:
            total += d * v                  # lm head
        total += d                          # final norm
        return total

    def _ssm_block_params(self) -> int:
        d = self.d_model
        din = self.d_inner
        g, n, h = self.ssm_n_groups, self.ssm_state, self.ssm_n_heads
        conv_ch = din + 2 * g * n
        in_proj = d * (2 * din + 2 * g * n + h)
        return in_proj + conv_ch * self.conv_width + 3 * h + din + din * d + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        routed_active = 3 * d * self.moe_d_ff * self.experts_top_k
        shared = 3 * d * self.shared_expert_d_ff if self.shared_expert_d_ff else 0
        router = d * self.n_experts
        block = attn + 2 * d + routed_active + shared + router
        total = self.n_layers * block + self.vocab * self.d_model
        if not self.tie_embeddings:
            total += self.d_model * self.vocab
        return total
