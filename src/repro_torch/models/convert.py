"""Carry the reference model's weights across to the port.

The reference (`repro.models`) initialises a pytree with ``blocks`` stacked
on a leading layer axis; the port keeps a list of per-layer dicts.  Its
matrices and biases are kept in the compute dtype once, which is what the
reference's ``.astype(compute_dtype)`` at every use computes; norm scales
stay f32.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.cluster import resolve_device

from . import lm
from .common import ModelConfig, Params


def _leaf(key: str, x, cfg: ModelConfig, dev) -> torch.Tensor:
    t = torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)
    return t if key == "scale" else t.to(cfg.compute_dtype)


def _convert(tree: Mapping[str, Any], cfg: ModelConfig, dev) -> dict:
    return {key: (_convert(val, cfg, dev) if isinstance(val, Mapping)
                  else _leaf(key, val, cfg, dev))
            for key, val in tree.items()}


def _layer(tree: Mapping[str, Any], i: int) -> dict:
    return {key: (_layer(val, i) if isinstance(val, Mapping) else val[i])
            for key, val in tree.items()}


def load_reference_params(cfg: ModelConfig, tree: Mapping[str, Any],
                          device: str | torch.device = "cuda") -> Params:
    """The port's params from the reference's ``api.init`` pytree (leaves as
    numpy arrays or anything ``np.array`` reads)."""
    lm._require_attn(cfg)
    dev = resolve_device(device)
    top = {k: v for k, v in tree.items() if k != "blocks"}
    params = _convert(top, cfg, dev)
    params["blocks"] = [_convert(_layer(tree["blocks"], i), cfg, dev)
                        for i in range(cfg.n_layers)]
    return params
