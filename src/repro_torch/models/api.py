"""Uniform model API (the serving entry point) over every family: the
decoder-only ones (dense, VLM, MoE, recurrent) and the encoder-decoder."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.cluster import resolve_device

from . import encdec, lm
from .common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], Any]                      # seed -> params
    prefill: Callable[[Any, dict, int], tuple]      # -> (logits, caches)
    decode_step: Callable[[Any, Any, Any, int], tuple]  # -> (logits, caches)


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda"
                ) -> ModelApi:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU)."""
    cfg.validate()
    dev = resolve_device(device)

    def generator(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    if cfg.is_encdec:
        return ModelApi(
            cfg=cfg,
            device=dev,
            init=lambda seed: encdec.encdec_init(generator(seed), cfg),
            prefill=lambda p, b, cap: encdec.encdec_prefill(p, cfg, b, cap),
            decode_step=lambda p, c, t, pos: encdec.encdec_decode_step(
                p, cfg, c, t, pos),
        )
    return ModelApi(
        cfg=cfg,
        device=dev,
        init=lambda seed: lm.lm_init(generator(seed), cfg),
        prefill=lambda p, b, cap: lm.lm_prefill(p, cfg, b, cap),
        decode_step=lambda p, c, t, pos: lm.lm_decode_step(p, cfg, c, t, pos),
    )
