"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

The port's registry holds the JAX package's thirteen configurations, in
its order: the paper's three CNNs and the ten LMs, that is the dense
family (qwen1.5-4b, phi4-mini-3.8b, stablelm-1.6b, llama3.2-1b), the RG-LRU
hybrid recurrentgemma-2b, the MoE family (deepseek-moe-16b, mixtral-8x7b),
the RWKV6 recurrence rwkv6-7b, the multimodal patch stub
llava-next-mistral-7b and the encoder-decoder whisper-small.  ``ARCHS``
lists the LMs and ``CNNS`` the CNNs, each by its config's ``family``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import (  # noqa: F401
    FlowConfig, ModelConfig, ShapeConfig, SHAPES,
)

_MODULES: Dict[str, str] = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen1.5-4b": "qwen15_4b",
    "phi4-mini-3.8b": "phi4_mini_38b",
    "stablelm-1.6b": "stablelm_16b",
    "llama3.2-1b": "llama32_1b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "rwkv6-7b": "rwkv6_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-small": "whisper_small",
    "lenet5": "lenet5",
    "mobilenetv1": "mobilenetv1",
    "resnet34": "resnet34",
}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).SMOKE


# the LMs, and the paper's own networks
ARCHS: List[str] = [a for a in _MODULES if get_config(a).family != "cnn"]
CNNS: List[str] = [a for a in _MODULES if get_config(a).family == "cnn"]

# archs with sub-quadratic decode state run long_500k; the pure
# full-attention archs skip it (the JAX package's DESIGN.md)
LONG_CONTEXT_OK = ("recurrentgemma-2b", "mixtral-8x7b", "rwkv6-7b")


def cells(include_skipped: bool = False) -> List[Tuple[str, str, bool]]:
    """The 40 (arch, shape, runnable) cells of the LMs by the shapes of
    :data:`SHAPES` (the dry-run's ``--all``); a full-attention arch's
    ``long_500k`` is not runnable and is listed only with
    ``include_skipped``."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            runnable = not (s == "long_500k" and a not in LONG_CONTEXT_OK)
            if runnable or include_skipped:
                out.append((a, s, runnable))
    return out
