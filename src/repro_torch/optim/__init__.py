from repro_torch.optim import adamw, compression  # noqa: F401
