"""Assigned-architecture configs.  Importing this package registers every
--arch id (full config + "<id>-smoke" reduced variant) with models.registry.
"""
from repro_torch.configs import (  # noqa: F401
    genie_datasets,
    grok_1_314b,
    internvl2_76b,
    mamba2_1_3b,
    mistral_large_123b,
    phi3_mini_3_8b,
    qwen2_5_14b,
    qwen2_moe_a2_7b,
    seamless_m4t_large_v2,
    smollm_360m,
    zamba2_2_7b,
)

ALL_ARCHS = [
    "phi3-mini-3.8b",
    "mistral-large-123b",
    "qwen2.5-14b",
    "smollm-360m",
    "mamba2-1.3b",
    "zamba2-2.7b",
    "qwen2-moe-a2.7b",
    "grok-1-314b",
    "internvl2-76b",
    "seamless-m4t-large-v2",
]
