"""Architecture and shape registries, filled by the per-architecture config
modules and `configs.shapes`."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig

ARCHS: Dict[str, ModelConfig] = {}
SHAPES: Dict[str, ShapeConfig] = {}

_ARCH_MODULES = ["internlm2_1_8b", "qwen3_32b", "nemotron_4_15b",
                 "chameleon_34b", "qwen2_moe_a2_7b", "moonshot_v1_16b_a3b",
                 "minicpm3_4b", "zamba2_7b", "xlstm_350m", "whisper_large_v3",
                 "paper_logreg", "paper_mlp"]


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def register_shape(cfg: ShapeConfig) -> ShapeConfig:
    SHAPES[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    importlib.import_module("repro_torch.configs.shapes")
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:  # a module imported directly registers only itself
        _load_all()
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        _load_all()
    return SHAPES[name]


def all_archs() -> Dict[str, ModelConfig]:
    _load_all()
    return dict(ARCHS)


def all_shapes() -> Dict[str, ShapeConfig]:
    _load_all()
    return dict(SHAPES)
