from repro_torch.checkpoint import checkpointer  # noqa: F401
