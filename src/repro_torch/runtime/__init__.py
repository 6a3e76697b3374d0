from repro_torch.runtime import fault  # noqa: F401
