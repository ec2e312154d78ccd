"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) expert d_ff=32768
vocab=131072, MoE 8 experts top-2, attention logit softcap 30.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=131072, attn_logit_softcap=30.0,
    n_experts=8, experts_top_k=2, moe_d_ff=32768, shared_expert_d_ff=0,
    capacity_factor=1.25,
))

SMOKE = register(ModelConfig(
    arch_id="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=0, vocab=512, attn_logit_softcap=30.0,
    n_experts=4, experts_top_k=2, moe_d_ff=128, shared_expert_d_ff=0,
    capacity_factor=1.25,
))
