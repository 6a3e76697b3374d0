"""Model zoo of the port: every family of the JAX package (``build(cfg)``)."""

from repro_torch.models.model_zoo import (  # noqa: F401
    ModelApi,
    build,
    input_specs,
    synthesize_batch,
)
