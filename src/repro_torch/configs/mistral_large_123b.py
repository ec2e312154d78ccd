"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768, rope_theta=1_000_000.0,
))

SMOKE = register(ModelConfig(
    arch_id="mistral-large-123b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, rope_theta=1_000_000.0,
))
