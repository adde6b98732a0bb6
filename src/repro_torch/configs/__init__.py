"""Architecture config registry: ``get_config(arch)`` / ``get_smoke(arch)``.

A copy of ``repro.configs``: every architecture's ``CONFIG`` and
``smoke()`` are data; :mod:`repro_torch.models.registry` runs each
family's model.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (ModelConfig, ServeConfig, ShapeConfig,
                                      SHAPES, TrainConfig, get_shape)

_MODULES: Dict[str, str] = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
}

ARCHS = tuple(_MODULES)

__all__ = ["ARCHS", "ModelConfig", "SHAPES", "ServeConfig", "ShapeConfig",
           "TrainConfig", "get_config", "get_shape", "get_smoke"]


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).smoke()
