"""Feed-forward layers of the dense family: gated MLP (SwiGLU/GeGLU) and the
plain (relu) MLP.  The reference's MoE comes with the MoE slice."""
from __future__ import annotations

import torch

from .common import ACTIVATIONS, ModelConfig, dense_init


def mlp_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, cd = cfg.d_model, cfg.d_ff, cfg.compute_dtype
    if cfg.act == "relu":  # non-gated (classic transformer)
        return {
            "w_in": dense_init(gen, (d, f), dtype=cd),
            "w_out": dense_init(gen, (f, d), dtype=cd),
        }
    return {
        "w_gate": dense_init(gen, (d, f), dtype=cd),
        "w_up": dense_init(gen, (d, f), dtype=cd),
        "w_down": dense_init(gen, (f, d), dtype=cd),
    }


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    if "w_in" in p:
        return act(x @ p["w_in"]) @ p["w_out"]
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
