from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ArchConfig,
    ShapeCell,
    reduced,
    shape_applicable,
)
from repro_torch.configs.registry import (  # noqa: F401
    ASSIGNED_ARCHS,
    PAPER_MODELS,
    get_config,
    list_archs,
)
