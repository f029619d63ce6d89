"""Carry the reference model's weights across to the port.

The reference (`repro.models`) initialises a pytree with ``blocks`` (and a
griffin model's ``tail``, an encoder-decoder's ``encoder`` and ``decoder``)
stacked on a leading layer axis; the port keeps a list of per-layer dicts,
with the same nested keys (``attn``/``mlp``/``moe``, rwkv's ``tm``/``cm``,
griffin's ``sub0..2`` and ``mix``, the decoder's ``self_attn``/``ln_x``/
``cross_attn``).  Each
leaf is kept in the dtype the reference uses it in: the parameters it
applies in f32 stay f32 (norm scales, the MoE router, rwkv's ``w0``,
``wd2``, ``u`` and ``gn_scale``, the rg-lru's ``w_r``, ``w_i``, ``b_r``,
``b_i`` and ``lam``); every other one is kept in the compute dtype once,
which is what the reference's ``.astype(compute_dtype)`` at every use
computes.

Training keeps a master tree of the same shape with every leaf in f32, as
the reference trains its f32 ``api.init`` tree: ``load_reference_master``
carries that tree across, ``master_params`` lifts the port's own seeded
init to f32, and ``working_params`` is the cast the loss makes at each
step (by the same rule, with autograd, so that the gradients land on the
master leaves in f32 as ``jax.grad`` of ``w.astype(compute_dtype)`` gives
them).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.cluster import resolve_device

from . import lm
from . import recurrent as rec
from .common import ModelConfig, Params


def f32_keys(name: str, tree: Mapping[str, Any]) -> frozenset[str]:
    """The keys of the sub-tree ``tree`` (under key ``name``) that the
    reference uses in f32: by the layer the sub-tree is (an rg-lru ``mix``
    holds ``lam``; an attention ``mix`` does not), beside every ``scale``."""
    keys = {"scale"}
    if name == "moe":
        keys.add("router")
    elif name == "tm":
        keys.update(rec.RWKV_F32)
    elif name == "mix" and "lam" in tree:
        keys.update(rec.RGLRU_F32)
    return frozenset(keys)


def _convert(name: str, tree: Mapping[str, Any], cfg: ModelConfig,
             dev, master: bool = False) -> dict:
    f32 = f32_keys(name, tree)
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = _convert(key, val, cfg, dev, master)
        else:
            t = torch.from_numpy(np.array(val, dtype=np.float32)).to(dev)
            out[key] = t if master or key in f32 else t.to(cfg.compute_dtype)
    return out


def _layer(tree: Mapping[str, Any], i: int) -> dict:
    return {key: (_layer(val, i) if isinstance(val, Mapping) else val[i])
            for key, val in tree.items()}


def _layers(tree: Mapping[str, Any], n: int, cfg: ModelConfig,
            dev, master: bool) -> list[dict]:
    first = tree
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    if len(first) != n:
        raise ValueError(f"{cfg.name}: the tree stacks {len(first)} layers "
                         f"where the config has {n}")
    return [_convert("", _layer(tree, i), cfg, dev, master) for i in range(n)]


def layer_stacks(cfg: ModelConfig) -> dict[str, int]:
    """The keys of the params that hold per-layer lists (the reference
    stacks them on a leading axis), with their lengths."""
    if cfg.is_encdec:
        return {"encoder": cfg.enc_layers, "decoder": cfg.dec_layers}
    return dict(zip(("blocks", "tail"), lm._n_scanned(cfg)))


def _load(cfg, tree, device, master: bool) -> Params:
    dev = resolve_device(device)
    stacks = layer_stacks(cfg)
    params = _convert("", {k: v for k, v in tree.items() if k not in stacks},
                      cfg, dev, master)
    for name, n in stacks.items():
        if n:
            params[name] = _layers(tree[name], n, cfg, dev, master)
    return params


def load_reference_params(cfg: ModelConfig, tree: Mapping[str, Any],
                          device: str | torch.device = "cuda") -> Params:
    """The port's params from the reference's ``api.init`` pytree (leaves as
    numpy arrays or anything ``np.array`` reads)."""
    return _load(cfg, tree, device, master=False)


def load_reference_master(cfg: ModelConfig, tree: Mapping[str, Any],
                          device: str | torch.device = "cuda") -> Params:
    """The port's f32 master tree (the train state's params) from the
    reference's f32 ``api.init`` pytree: every leaf in f32, the stacked
    layers split into lists."""
    return _load(cfg, tree, device, master=True)


def master_params(params: Params) -> Params:
    """An f32 copy of a params tree (the port's seeded ``api.init``)."""
    if isinstance(params, torch.Tensor):
        return params.detach().float().clone()
    if isinstance(params, Mapping):
        return {key: master_params(val) for key, val in params.items()}
    return [master_params(layer) for layer in params]


def working_params(cfg: ModelConfig, params: Params) -> Params:
    """The tree the forward uses, cast from ``params`` (a master tree, or
    one already in the compute dtype) by `f32_keys`: the leaves the
    reference uses in f32 as they are, every other one in the compute
    dtype.  The casts are differentiable, and a leaf already in its dtype
    is passed through."""
    def walk(name, tree):
        if not isinstance(tree, Mapping):
            return [walk("", layer) for layer in tree]
        f32 = f32_keys(name, tree)
        return {key: (walk(key, val) if not isinstance(val, torch.Tensor)
                      else val if key in f32 else val.to(cfg.compute_dtype))
                for key, val in tree.items()}

    return walk("", params)
