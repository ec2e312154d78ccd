"""Assigned-architecture configs of the ported families (dense, moe, vlm).
Importing this package registers every ported --arch id (full config +
"<id>-smoke" reduced variant) with models.registry.  The ssm, hybrid and
audio archs of the reference (mamba2-1.3b, zamba2-2.7b,
seamless-m4t-large-v2) are ROADMAP.md queue 1 item 11b.
"""
from repro_torch.configs import (  # noqa: F401
    genie_datasets,
    grok_1_314b,
    internvl2_76b,
    mistral_large_123b,
    phi3_mini_3_8b,
    qwen2_5_14b,
    qwen2_moe_a2_7b,
    smollm_360m,
)

ALL_ARCHS = [
    "phi3-mini-3.8b",
    "mistral-large-123b",
    "qwen2.5-14b",
    "smollm-360m",
    "qwen2-moe-a2.7b",
    "grok-1-314b",
    "internvl2-76b",
]
