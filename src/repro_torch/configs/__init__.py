"""Architecture config registry of the port: ``--arch <id>`` resolution.

The same ten archs, in the same order, as ``repro/configs/__init__.py``;
each module is a copy of the JAX package's with the port's
``ModelConfig``.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-4b": "qwen1_5_4b",
    "qwen2.5-3b": "qwen2_5_3b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "arctic-480b": "arctic_480b",
    "whisper-medium": "whisper_medium",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCHS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
