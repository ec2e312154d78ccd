"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 -- InternViT + InternLM2 backbone.  [arXiv:2404.16821;
unverified]

The InternViT frontend is a STUB: input_specs feeds precomputed patch
embeddings [B, 256, d_model]; the 80-layer LLM backbone is fully built.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, rope_theta=1_000_000.0,
    n_patches=256,
))

SMOKE = register(ModelConfig(
    arch_id="internvl2-76b-smoke", family="vlm",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, rope_theta=1_000_000.0,
    n_patches=8,
))
