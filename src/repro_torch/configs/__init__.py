"""Architecture config registry of the port.

Only the archs whose whole path is ported resolve. Every other arch of
the JAX package raises KeyError naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-32b": "qwen3_32b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

# archs of the JAX package that the port does not serve yet
_PENDING = {
    "arctic-480b": "Queue 1, remaining archs",
    "qwen1.5-4b": "Queue 1, remaining archs",
    "gemma3-27b": "Queue 1, remaining archs",
    "whisper-medium": "Queue 1, remaining archs",
    "llava-next-mistral-7b": "Queue 1, remaining archs",
}

ARCHS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch in _PENDING:
        raise KeyError(f"arch {arch!r} is not ported yet; see ROADMAP.md "
                       f"{_PENDING[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
