"""Config registry: ``--arch <id>`` resolution for the port's launchers.

The port carries the paper's three encoder models and the dense decoder
OLMo-1B; the other architectures of the JAX package arrive with the
slices that can run them.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "mobilebert": "mobilebert",
    "dinov2-small": "dinov2_small",
    "whisper-tiny-encoder": "whisper_tiny_encoder",
    "olmo-1b": "olmo_1b",
}

PAPER_MODELS = ("mobilebert", "dinov2-small", "whisper-tiny-encoder")


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_MODULES)
