"""Architecture registry: ``--arch <id>`` selectable configs + shapes.

The port has the dense family so far.  The other arch ids of the reference
are known here and raise `NotImplementedError` naming the slice that brings
them (ROADMAP §1).
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

from .shapes import (SHAPES, ShapeSpec, cache_capacity, shape_applicable,
                     supports_long_context)

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-8b": "qwen3_8b",
}

#: arch ids of the reference that the port does not have yet, and why
NOT_PORTED = {
    "mixtral-8x7b": "MoE family",
    "olmoe-1b-7b": "MoE family",
    "rwkv6-7b": "recurrent (RWKV6) family",
    "recurrentgemma-9b": "recurrent (RG-LRU) hybrid family",
    "seamless-m4t-medium": "encoder-decoder family",
    "paligemma-3b": "VLM (patch prefix) family",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} belongs to the {NOT_PORTED[arch]}, which the port "
            "does not have yet: it comes with the model-side slice after the "
            f"dense serving path (ROADMAP §1); ported: {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = [
    "ARCH_IDS", "NOT_PORTED", "get_config", "SHAPES",
    "ShapeSpec", "cache_capacity", "shape_applicable",
    "supports_long_context",
]
