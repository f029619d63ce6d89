"""Architecture registry: ``--arch <id>`` selectable configs + shapes.

Every arch id of the reference, in its order: the dense, VLM
(paligemma-3b), MoE, encoder-decoder (seamless-m4t-medium) and recurrent
(RWKV6, RG-LRU hybrid) families.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

from .shapes import (SHAPES, ShapeSpec, batch_specs, cache_capacity,
                     decode_specs, shape_applicable, supports_long_context)

_MODULES = {
    "paligemma-3b": "paligemma_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-8b": "qwen3_8b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS", "get_config", "all_configs", "SHAPES", "ShapeSpec",
    "batch_specs", "cache_capacity", "decode_specs", "shape_applicable",
    "supports_long_context",
]
