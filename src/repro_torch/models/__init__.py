# LM scaffolding: the serving path of the six architecture families.
from repro_torch.models import (  # noqa: F401
    config, encdec, hybrid, layers, moe, registry, ssm, transformer,
)
from repro_torch.models.config import ModelConfig  # noqa: F401
