"""Architecture config registry: ``get_config("<arch-id>")`` / ``--arch``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape

_MODULES = {
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> "dict[str, ArchConfig]":
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ARCH_NAMES", "get_config", "all_configs"]
