"""Architecture registry, filled by the per-architecture config modules."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {}

_ARCH_MODULES = ["internlm2_1_8b", "qwen3_32b", "nemotron_4_15b",
                 "chameleon_34b", "qwen2_moe_a2_7b", "moonshot_v1_16b_a3b",
                 "minicpm3_4b", "zamba2_7b", "xlstm_350m", "whisper_large_v3",
                 "paper_logreg"]


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:  # a module imported directly registers only itself
        for mod in _ARCH_MODULES:
            importlib.import_module(f"repro_torch.configs.{mod}")
    return ARCHS[name]
