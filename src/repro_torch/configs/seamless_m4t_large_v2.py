"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206, GELU FFN.
[arXiv:2308.11596; hf]

The speech frontend is a STUB: input_specs feeds precomputed frame
embeddings [B, S, d_model]; encoder/decoder backbones are fully built.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_encoder_layers=24, is_encoder_decoder=True,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, mlp_type="gelu",
))

SMOKE = register(ModelConfig(
    arch_id="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=2, n_encoder_layers=2, is_encoder_decoder=True,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=192, vocab=512, mlp_type="gelu",
))
