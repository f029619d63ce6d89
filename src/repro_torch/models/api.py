"""Uniform model API (the serving entry point), dense family."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.cluster import resolve_device

from . import lm
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
    for the CPU).  Raises for the families the port does not have yet."""
    cfg.validate()
    if cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and patch-frontend models are not "
            "ported yet")
    lm._require_attn(cfg)
    dev = resolve_device(device)

    def init(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return lm.lm_init(gen, cfg)

    return ModelApi(
        cfg=cfg,
        device=dev,
        init=init,
        prefill=lambda p, b, cap: lm.lm_prefill(p, cfg, b, cap),
        decode_step=lambda p, c, t, pos: lm.lm_decode_step(p, cfg, c, t, pos),
    )
