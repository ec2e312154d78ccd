from repro_torch.optim import adamw, compress, schedule  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig, AdamWState  # noqa: F401
