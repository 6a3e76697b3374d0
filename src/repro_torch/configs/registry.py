"""Config registry: ``--arch <id>`` resolution for the port's launchers and tests."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    # assigned architectures (10)
    "qwen1.5-110b": "qwen1_5_110b",
    "mistral-large-123b": "mistral_large_123b",
    "stablelm-1.6b": "stablelm_1_6b",
    "olmo-1b": "olmo_1b",
    "zamba2-2.7b": "zamba2_2_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-370m": "mamba2_370m",
    "llava-next-34b": "llava_next_34b",
    # the paper's own models (3)
    "mobilebert": "mobilebert",
    "dinov2-small": "dinov2_small",
    "whisper-tiny-encoder": "whisper_tiny_encoder",
}

ASSIGNED_ARCHS = tuple(list(_MODULES)[:10])
PAPER_MODELS = tuple(list(_MODULES)[10:])


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_MODULES)
