"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

The port's registry holds the paper's three CNNs and the first LM,
llama3.2-1b; the other LM configs join it with their families (ROADMAP
Queue 1).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    FlowConfig, ModelConfig, ShapeConfig, SHAPES,
)

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "llama32_1b",
    "lenet5": "lenet5",
    "mobilenetv1": "mobilenetv1",
    "resnet34": "resnet34",
}

ARCHS: List[str] = list(_MODULES)[:1]           # the LMs ported so far
CNNS: List[str] = list(_MODULES)[1:]            # the paper's own networks


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).SMOKE
