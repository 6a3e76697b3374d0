from repro_torch.optim import adamw  # noqa: F401
