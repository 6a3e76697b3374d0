from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401
from repro_torch.configs.registry import PAPER_MODELS, get_config, list_archs  # noqa: F401
