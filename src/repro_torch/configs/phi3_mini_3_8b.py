"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 -- RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, rope_theta=10_000.0,
))

SMOKE = register(ModelConfig(
    arch_id="phi3-mini-3.8b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, rope_theta=10_000.0,
))
