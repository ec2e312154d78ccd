"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) routed-expert
d_ff=1408 vocab=151936, MoE 60 experts top-4 + 4 shared experts (shared
intermediate 4*1408=5632, sigmoid-gated).  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab=151936, qkv_bias=True,
    n_experts=60, experts_top_k=4, moe_d_ff=1408, shared_expert_d_ff=5632,
    capacity_factor=1.25,
))

SMOKE = register(ModelConfig(
    arch_id="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=512, qkv_bias=True,
    n_experts=8, experts_top_k=2, moe_d_ff=48, shared_expert_d_ff=96,
    capacity_factor=1.25,
))
