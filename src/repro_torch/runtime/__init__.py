from repro_torch.runtime import elastic, fault, sharding  # noqa: F401
