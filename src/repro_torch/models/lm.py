"""Decoder-only language model, the ``"attn"`` block kind (dense family).

A block is attention + gated MLP with pre-RMSNorm.  Blocks are a list of
per-layer dicts run in a Python loop (the reference stacks them and runs
``lax.scan``); caches are a list of per-layer dicts.  The other block kinds
of the reference (moe, rwkv, griffin) raise until their slices land.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn
from .common import ModelConfig, Params, embed_init, rmsnorm, rmsnorm_init


def block_kind(cfg: ModelConfig) -> str:
    if cfg.attn_pattern == "rwkv":
        return "rwkv"
    if cfg.attn_pattern == "griffin_1_2":
        return "griffin"
    return "moe" if cfg.moe is not None else "attn"


def _require_attn(cfg: ModelConfig) -> None:
    kind = block_kind(cfg)
    if kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: block kind {kind!r} is not ported yet; the port "
            "has the dense 'attn' block")


def _attn_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "attn": attn.attn_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, dev),
        "mlp": ffn.mlp_init(gen, cfg),
    }


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Seeded random weights on the generator's device: matrices in the
    compute dtype, norm scales in f32."""
    _require_attn(cfg)
    cd = cfg.compute_dtype
    params: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype=cd),
        "blocks": [_attn_block_init(gen, cfg) for _ in range(cfg.n_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.vocab, cfg.d_model,
                                    dtype=cd).T.contiguous()
    return params


# ---------------------------------------------------------------------------------
# full-sequence block application (prefill)
# ---------------------------------------------------------------------------------

def _apply_attn_block(bp, cfg: ModelConfig, x, positions, window,
                      capacity=None):
    h, (k, v) = attn.attn_forward(bp["attn"], cfg,
                                  rmsnorm(bp["ln1"], x, cfg.rms_eps),
                                  positions=positions, causal=True,
                                  window=window)
    x = x + h
    x = x + ffn.mlp_apply(bp["mlp"], cfg, rmsnorm(bp["ln2"], x, cfg.rms_eps))
    cache = None
    if capacity is not None:
        cache = attn.fill_cache(
            attn.init_cache(cfg, x.shape[0], capacity, device=x.device),
            k, v, positions[0])
    return x, cache


def _forward_blocks(params, cfg: ModelConfig, x, positions, capacity):
    """Run all blocks.  Returns (hidden, per-layer caches)."""
    caches = []
    for bp in params["blocks"]:
        x, cache = _apply_attn_block(bp, cfg, x, positions, cfg.swa_window,
                                     capacity)
        caches.append(cache)
    return x, caches


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
    """Prefill: returns (last-token logits [B,V] f32, per-layer caches)."""
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
    return x1 + ffn.mlp_apply(bp["mlp"], cfg, xn[:, None])[:, 0], cache


def lm_decode_step(params, cfg: ModelConfig, caches, token, pos: int):
    """One token for the whole batch.  token: [B] int, pos: int.

    Returns (logits [B,V] f32, caches), the caches updated in place."""
    x1 = embed_tokens(params, cfg, token[:, None])[:, 0]
    for bp, cache in zip(params["blocks"], caches):
        x1, _ = _decode_attn_block(bp, cfg, x1, cache, pos, cfg.swa_window)
    x1 = rmsnorm(params["final_norm"], x1, cfg.rms_eps)
    return last_token_logits(params, cfg, x1), caches
