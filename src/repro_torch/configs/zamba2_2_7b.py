"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 -- Mamba2 backbone + weight-shared attention
blocks (every 6 layers, per-invocation LoRA).  [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_n_groups=1,
    conv_width=4, ssd_chunk=256, shared_attn_period=6,    use_tp=False,
))

SMOKE = register(ModelConfig(
    arch_id="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=512,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_n_groups=1,
    conv_width=4, ssd_chunk=8, shared_attn_period=2,
))
