from repro_torch.data import pipeline  # noqa: F401
