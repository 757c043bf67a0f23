"""Architecture registry: ``--arch <id>`` resolution for launchers/tests."""
from __future__ import annotations

import importlib

from .base import ArchConfig, smoke_variant

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "xlstm-1.3b": "xlstm_1_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-small": "whisper_small",
    "qwen3-0.6b": "qwen3_0_6b",
    "chameleon-34b": "chameleon_34b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mistral-large-123b": "mistral_large_123b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.smoke()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
