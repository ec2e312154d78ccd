"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 -- GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
))

SMOKE = register(ModelConfig(
    arch_id="qwen2.5-14b-smoke", family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=224, vocab=512, qkv_bias=True, rope_theta=1_000_000.0,
))
