# LM scaffolding, the serving path of the dense, moe and vlm families (the
# ssm, hybrid and audio families are still to be ported).
from repro_torch.models import config, layers, moe, registry, transformer  # noqa: F401
from repro_torch.models.config import ModelConfig  # noqa: F401
