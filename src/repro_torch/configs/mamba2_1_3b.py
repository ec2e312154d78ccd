"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2*d_model = 4096, head_dim 64 -> 64 SSD heads, 1 B/C group.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import register

FULL = register(ModelConfig(
    arch_id="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_n_groups=1,
    conv_width=4, ssd_chunk=256,    use_tp=False,
))

SMOKE = register(ModelConfig(
    arch_id="mamba2-1.3b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=512, tie_embeddings=True,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_n_groups=1,
    conv_width=4, ssd_chunk=8,
))
