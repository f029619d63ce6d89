"""Assigned input shapes per (arch × shape), and the KV-cache capacity.

LM transformer shapes are seq_len × global_batch.  ``decode_*`` / ``long_*``
are one new token against a KV cache of seq_len.  ``long_500k`` requires
sub-quadratic attention and only runs for SSM / hybrid / SWA-bounded archs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cache_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """KV-cache slots needed for a context of seq_len under this arch."""
    if cfg.swa_window is not None:
        return min(seq_len, cfg.swa_window)
    return seq_len


def supports_long_context(cfg: ModelConfig) -> bool:
    """Sub-quadratic context: SSM state, Griffin local-attn, or SWA window."""
    return (cfg.attn_pattern in ("rwkv", "griffin_1_2")
            or cfg.swa_window is not None)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not supports_long_context(cfg):
        return False, ("full-attention arch: 500k dense KV decode is "
                       "unbounded/quadratic — skipped per assignment")
    return True, ""
