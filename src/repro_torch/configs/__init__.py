"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

The port's registry holds the paper's three CNNs; the LM configs join it with
the LM slice (ROADMAP Queue 1, item 5).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    FlowConfig, ModelConfig, ShapeConfig, SHAPES,
)

_MODULES: Dict[str, str] = {
    "lenet5": "lenet5",
    "mobilenetv1": "mobilenetv1",
    "resnet34": "resnet34",
}

CNNS: List[str] = list(_MODULES)                # the paper's own networks


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).SMOKE
