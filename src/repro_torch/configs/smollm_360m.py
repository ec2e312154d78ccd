"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
-- llama-arch small, tied embeddings.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49152, tie_embeddings=True, rope_theta=10_000.0, use_tp=False,
))

SMOKE = register(ModelConfig(
    arch_id="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
    d_ff=160, vocab=512, tie_embeddings=True, rope_theta=10_000.0,
))
