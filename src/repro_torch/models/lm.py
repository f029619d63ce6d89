"""Decoder-only language model over the dense, MoE and recurrent families.

Families map to block kinds, as in the reference:
  dense              -> "attn"      (attn + gated MLP)
  moe                -> "moe"       (attn + top-k MoE; optional SWA)
  ssm (rwkv6)        -> "rwkv"      (time-mix + channel-mix)
  hybrid (rec.gemma) -> "griffin"   (period-3 super-block: rglru, rglru,
                                     local-attn — each followed by an MLP)

Blocks are a list of per-layer dicts run in a Python loop (the reference
stacks them and runs ``lax.scan``); caches are a list of per-layer dicts.
A griffin model with ``n_layers % 3`` left over runs that many rg-lru
layers after its super-blocks (``tail``), and its caches take the
reference's ``{"main": [...], "tail": [...]}`` shape.  The MoE's
load-balance aux is dropped on the serving path, as the reference drops it.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn
from . import recurrent as rec
from .common import ModelConfig, Params, embed_init, rmsnorm, rmsnorm_init


def block_kind(cfg: ModelConfig) -> str:
    if cfg.attn_pattern == "rwkv":
        return "rwkv"
    if cfg.attn_pattern == "griffin_1_2":
        return "griffin"
    return "moe" if cfg.moe is not None else "attn"


# ---------------------------------------------------------------------------------
# block init
# ---------------------------------------------------------------------------------

def _attn_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "attn": attn.attn_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, dev),
    }
    if cfg.moe is not None:
        p["moe"] = ffn.moe_init(gen, cfg)
    else:
        p["mlp"] = ffn.mlp_init(gen, cfg)
    return p


def _rwkv_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "tm": rec.rwkv_timemix_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, dev),
        "cm": rec.rwkv_channelmix_init(gen, cfg),
    }


def _griffin_sub_init(gen: torch.Generator, cfg: ModelConfig,
                      temporal: str) -> dict:
    dev = gen.device
    mix = (rec.rglru_block_init(gen, cfg) if temporal == "rglru"
           else attn.attn_init(gen, cfg))
    return {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "mix": mix,
        "ln2": rmsnorm_init(cfg.d_model, dev),
        "mlp": ffn.mlp_init(gen, cfg),
    }


#: a griffin super-block: its sub-blocks' keys and temporal mixes, in order
GRIFFIN_SUBS = (("sub0", "rglru"), ("sub1", "rglru"), ("sub2", "attn"))


def _griffin_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {sub: _griffin_sub_init(gen, cfg, temporal)
            for sub, temporal in GRIFFIN_SUBS}


def _n_scanned(cfg: ModelConfig) -> tuple[int, int]:
    """(#blocks, #tail rglru layers) — a tail only for griffin depth % 3."""
    if block_kind(cfg) == "griffin":
        return cfg.n_layers // 3, cfg.n_layers % 3
    return cfg.n_layers, 0


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Seeded random weights on the generator's device: matrices in the
    compute dtype, norm scales and the parameters the reference uses in
    f32 (the MoE router, rwkv's decay and bonus, the rg-lru's gates) in
    f32."""
    cd = cfg.compute_dtype
    init_one = {
        "attn": _attn_block_init, "moe": _attn_block_init,
        "rwkv": _rwkv_block_init, "griffin": _griffin_block_init,
    }[block_kind(cfg)]
    n_blocks, n_tail = _n_scanned(cfg)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype=cd),
        "blocks": [init_one(gen, cfg) for _ in range(n_blocks)],
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
    }
    if n_tail:
        params["tail"] = [_griffin_sub_init(gen, cfg, "rglru")
                          for _ in range(n_tail)]
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.vocab, cfg.d_model,
                                    dtype=cd).T.contiguous()
    return params


# ---------------------------------------------------------------------------------
# full-sequence block application (prefill)
# ---------------------------------------------------------------------------------

def _kv_cache(cfg: ModelConfig, k, v, positions, capacity):
    cache = attn.init_cache(cfg, k.shape[0], capacity, device=k.device)
    return attn.fill_cache(cache, k, v, positions[0])


def _apply_attn_block(bp, cfg: ModelConfig, x, positions, window,
                      capacity=None):
    h, (k, v) = attn.attn_forward(bp["attn"], cfg,
                                  rmsnorm(bp["ln1"], x, cfg.rms_eps),
                                  positions=positions, causal=True,
                                  window=window)
    x = x + h
    xn = rmsnorm(bp["ln2"], x, cfg.rms_eps)
    if "moe" in bp:
        h, _ = ffn.moe_apply(bp["moe"], cfg, xn)
    else:
        h = ffn.mlp_apply(bp["mlp"], cfg, xn)
    x = x + h
    cache = None
    if capacity is not None:
        cache = _kv_cache(cfg, k, v, positions, capacity)
    return x, cache


def _apply_rwkv_block(bp, cfg: ModelConfig, x, collect: bool):
    h, tm_state = rec.rwkv_timemix_forward(bp["tm"], cfg,
                                           rmsnorm(bp["ln1"], x, cfg.rms_eps))
    x = x + h
    xn = rmsnorm(bp["ln2"], x, cfg.rms_eps)
    xn_prev = torch.cat([torch.zeros_like(xn[:, :1]), xn[:, :-1]], dim=1)
    x = x + rec.rwkv_channelmix(bp["cm"], cfg, xn, xn_prev)
    cache = None
    if collect:
        cache = {"S": tm_state["S"], "x_prev_tm": tm_state["x_prev"],
                 "x_prev_cm": xn[:, -1]}
    return x, cache


def _apply_griffin_sub(bp, cfg: ModelConfig, x, positions, temporal: str,
                       capacity=None):
    """One griffin sub-block; the local attention's cache holds
    ``min(capacity, local_window)`` slots."""
    xn = rmsnorm(bp["ln1"], x, cfg.rms_eps)
    cache = None
    if temporal == "rglru":
        h, state = rec.rglru_block_forward(bp["mix"], cfg, xn)
        if capacity is not None:
            cache = state
    else:
        h, (k, v) = attn.attn_forward(bp["mix"], cfg, xn, positions=positions,
                                      causal=True, window=cfg.local_window)
        if capacity is not None:
            cap = min(capacity, cfg.local_window or capacity)
            cache = _kv_cache(cfg, k, v, positions, cap)
    x = x + h
    x = x + ffn.mlp_apply(bp["mlp"], cfg, rmsnorm(bp["ln2"], x, cfg.rms_eps))
    return x, cache


def _forward_blocks(params, cfg: ModelConfig, x, positions, capacity):
    """Run all blocks.  Returns (hidden, caches)."""
    kind = block_kind(cfg)
    caches = []
    if kind in ("attn", "moe"):
        for bp in params["blocks"]:
            x, cache = _apply_attn_block(bp, cfg, x, positions,
                                         cfg.swa_window, capacity)
            caches.append(cache)
        return x, caches
    if kind == "rwkv":
        for bp in params["blocks"]:
            x, cache = _apply_rwkv_block(bp, cfg, x, capacity is not None)
            caches.append(cache)
        return x, caches
    for bp in params["blocks"]:                       # griffin
        cache = {}
        for sub, temporal in GRIFFIN_SUBS:
            x, cache[sub] = _apply_griffin_sub(bp[sub], cfg, x, positions,
                                               temporal, capacity)
        caches.append(cache)
    out = {"main": caches}
    if "tail" in params:
        out["tail"] = []
        for bp in params["tail"]:
            x, cache = _apply_griffin_sub(bp, cfg, x, positions, "rglru",
                                          capacity)
            out["tail"].append(cache)
    return x, out


# ---------------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    return x


def _head_weight(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T         # [D, V]
    return params["head"]


def last_token_logits(params, cfg: ModelConfig, hidden_last):
    """hidden_last: [B, D] -> [B, V] (f32)."""
    return (hidden_last @ _head_weight(params, cfg)).float()


# ---------------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------------

def lm_prefill(params, cfg: ModelConfig, batch, capacity: int):
    """Prefill: returns (last-token logits [B,V] f32, caches)."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    hidden, caches = _forward_blocks(params, cfg, x, positions, capacity)
    hidden = rmsnorm(params["final_norm"], hidden, cfg.rms_eps)
    return last_token_logits(params, cfg, hidden[:, -1]), caches


def _decode_attn_block(bp, cfg: ModelConfig, x1, cache, pos, window):
    h, cache = attn.attn_decode(bp["attn"], cfg,
                                rmsnorm(bp["ln1"], x1, cfg.rms_eps)[:, None],
                                cache, pos, window=window)
    x1 = x1 + h[:, 0]
    xn = rmsnorm(bp["ln2"], x1, cfg.rms_eps)
    if "moe" in bp:
        h = ffn.moe_apply(bp["moe"], cfg, xn[:, None])[0][:, 0]
    else:
        h = ffn.mlp_apply(bp["mlp"], cfg, xn[:, None])[:, 0]
    return x1 + h, cache


def _decode_rwkv_block(bp, cfg: ModelConfig, x1, cache):
    h, tm_state = rec.rwkv_timemix_decode(
        bp["tm"], cfg, rmsnorm(bp["ln1"], x1, cfg.rms_eps),
        {"S": cache["S"], "x_prev": cache["x_prev_tm"]})
    x1 = x1 + h
    xn = rmsnorm(bp["ln2"], x1, cfg.rms_eps)
    x1 = x1 + rec.rwkv_channelmix(bp["cm"], cfg, xn, cache["x_prev_cm"])
    return x1, {"S": tm_state["S"], "x_prev_tm": tm_state["x_prev"],
                "x_prev_cm": xn}


def _decode_griffin_sub(bp, cfg: ModelConfig, x1, cache, pos, temporal):
    xn = rmsnorm(bp["ln1"], x1, cfg.rms_eps)
    if temporal == "rglru":
        h, cache = rec.rglru_block_decode(bp["mix"], cfg, xn, cache)
    else:
        h, cache = attn.attn_decode(bp["mix"], cfg, xn[:, None], cache, pos,
                                    window=cfg.local_window)
        h = h[:, 0]
    x1 = x1 + h
    x1 = x1 + ffn.mlp_apply(bp["mlp"], cfg,
                            rmsnorm(bp["ln2"], x1, cfg.rms_eps)[:, None])[:, 0]
    return x1, cache


def lm_decode_step(params, cfg: ModelConfig, caches, token, pos: int):
    """One token for the whole batch.  token: [B] int, pos: int.

    Returns (logits [B,V] f32, caches): the KV caches updated in place, the
    recurrent states replaced."""
    kind = block_kind(cfg)
    x1 = embed_tokens(params, cfg, token[:, None])[:, 0]
    if kind in ("attn", "moe"):
        for bp, cache in zip(params["blocks"], caches):
            x1, _ = _decode_attn_block(bp, cfg, x1, cache, pos,
                                       cfg.swa_window)
    elif kind == "rwkv":
        new = []
        for bp, cache in zip(params["blocks"], caches):
            x1, cache = _decode_rwkv_block(bp, cfg, x1, cache)
            new.append(cache)
        caches = new
    else:                                             # griffin
        main = []
        for bp, cache in zip(params["blocks"], caches["main"]):
            new = {}
            for sub, temporal in GRIFFIN_SUBS:
                x1, new[sub] = _decode_griffin_sub(bp[sub], cfg, x1,
                                                   cache[sub], pos, temporal)
            main.append(new)
        out = {"main": main}
        if "tail" in params:
            out["tail"] = []
            for bp, cache in zip(params["tail"], caches["tail"]):
                x1, cache = _decode_griffin_sub(bp, cfg, x1, cache, pos,
                                                "rglru")
                out["tail"].append(cache)
        caches = out
    x1 = rmsnorm(params["final_norm"], x1, cfg.rms_eps)
    return last_token_logits(params, cfg, x1), caches
