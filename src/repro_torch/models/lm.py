"""Decoder-only language model over the dense, VLM, MoE and recurrent
families.

Families map to block kinds, as in the reference:
  dense, vlm         -> "attn"      (attn + gated MLP)
  moe                -> "moe"       (attn + top-k MoE; optional SWA)
  ssm (rwkv6)        -> "rwkv"      (time-mix + channel-mix)
  hybrid (rec.gemma) -> "griffin"   (period-3 super-block: rglru, rglru,
                                     local-attn — each followed by an MLP)

Blocks are a list of per-layer dicts run in a Python loop (the reference
stacks them and runs ``lax.scan``); caches are a list of per-layer dicts.
A griffin model with ``n_layers % 3`` left over runs that many rg-lru
layers after its super-blocks (``tail``), and its caches take the
reference's ``{"main": [...], "tail": [...]}`` shape.  The MoE's
load-balance aux is dropped on the serving path, as the reference drops it,
and added to the loss at 0.01.  A patch-frontend (VLM) prefill takes
``batch["prefix_embeds"]`` [B, P, d] in front of the text, under the
prefix-LM mask with P = ``frontend_len`` when the config sets
``prefix_lm``; positions count the prefix.

The loss (``lm_loss``) is next-token cross-entropy over the text, computed
in sequence chunks of ``LOSS_CHUNK`` so that the full [B, S, vocab] logits
never exist at once.  Where a loss is differentiated each block (a griffin
super-block, a tail layer) and each loss chunk runs under the config's
rematerialisation policy (``common.maybe_remat``), where the reference
applies ``jax.checkpoint``.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn
from . import recurrent as rec
from .common import (ModelConfig, Params, embed_init, maybe_remat, rmsnorm,
                     rmsnorm_init)

LOSS_CHUNK = 512


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
        "ln1": rmsnorm_init(cfg.d_model, device=dev),
        "attn": attn.attn_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, device=dev),
    }
    if cfg.moe is not None:
        p["moe"] = ffn.moe_init(gen, cfg)
    else:
        p["mlp"] = ffn.mlp_init(gen, cfg)
    return p


def _rwkv_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, device=dev),
        "tm": rec.rwkv_timemix_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, device=dev),
        "cm": rec.rwkv_channelmix_init(gen, cfg),
    }


def _griffin_sub_init(gen: torch.Generator, cfg: ModelConfig,
                      temporal: str) -> dict:
    dev = gen.device
    mix = (rec.rglru_block_init(gen, cfg) if temporal == "rglru"
           else attn.attn_init(gen, cfg))
    return {
        "ln1": rmsnorm_init(cfg.d_model, device=dev),
        "mix": mix,
        "ln2": rmsnorm_init(cfg.d_model, device=dev),
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
        "final_norm": rmsnorm_init(cfg.d_model, device=gen.device),
    }
    if n_tail:
        params["tail"] = [_griffin_sub_init(gen, cfg, "rglru")
                          for _ in range(n_tail)]
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.vocab, cfg.d_model,
                                    dtype=cd).T.contiguous()
    return params


# ---------------------------------------------------------------------------------
# full-sequence block application (train / prefill)
# ---------------------------------------------------------------------------------

def _kv_cache(cfg: ModelConfig, k, v, positions, capacity):
    cache = attn.init_cache(cfg, k.shape[0], capacity, device=k.device)
    return attn.fill_cache(cache, k, v, positions[0])


def _apply_attn_block(bp, cfg: ModelConfig, x, positions, window,
                      capacity=None, prefix_len=None):
    """One attention block: (x, cache, the MoE's load-balance loss, f32 0
    for a dense block)."""
    h, (k, v) = attn.attn_forward(bp["attn"], cfg,
                                  rmsnorm(bp["ln1"], x, cfg.rms_eps),
                                  positions=positions, causal=True,
                                  window=window, prefix_len=prefix_len)
    x = x + h
    xn = rmsnorm(bp["ln2"], x, cfg.rms_eps)
    if "moe" in bp:
        h, aux = ffn.moe_apply(bp["moe"], cfg, xn)
        lb = aux["load_balance_loss"]
    else:
        h = ffn.mlp_apply(bp["mlp"], cfg, xn)
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + h
    cache = None
    if capacity is not None:
        cache = _kv_cache(cfg, k, v, positions, capacity)
    return x, cache, lb


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


def _forward_blocks(params, cfg: ModelConfig, x, positions, capacity,
                    prefix_len=None):
    """Run all blocks, each under ``maybe_remat``.  Returns (hidden,
    caches, aux): aux holds the attention blocks' mean load-balance loss
    (0 for a dense model), as the reference's."""
    kind = block_kind(cfg)
    caches = []
    if kind in ("attn", "moe"):
        def attn_body(x, bp):
            return _apply_attn_block(bp, cfg, x, positions, cfg.swa_window,
                                     capacity, prefix_len)

        body, lbs = maybe_remat(attn_body, cfg), []
        for bp in params["blocks"]:
            x, cache, lb = body(x, bp)
            caches.append(cache)
            lbs.append(lb)
        return x, caches, {"load_balance_loss": torch.stack(lbs).mean()}
    if kind == "rwkv":
        body = maybe_remat(lambda x, bp: _apply_rwkv_block(
            bp, cfg, x, capacity is not None), cfg)
        for bp in params["blocks"]:
            x, cache = body(x, bp)
            caches.append(cache)
        return x, caches, {}

    def griffin_body(x, bp):
        cache = {}
        for sub, temporal in GRIFFIN_SUBS:
            x, cache[sub] = _apply_griffin_sub(bp[sub], cfg, x, positions,
                                               temporal, capacity)
        return x, cache

    def tail_body(x, bp):
        return _apply_griffin_sub(bp, cfg, x, positions, "rglru", capacity)

    body = maybe_remat(griffin_body, cfg)
    for bp in params["blocks"]:
        x, cache = body(x, bp)
        caches.append(cache)
    out = {"main": caches}
    if "tail" in params:
        out["tail"] = []
        body = maybe_remat(tail_body, cfg)
        for bp in params["tail"]:
            x, cache = body(x, bp)
            out["tail"].append(cache)
    return x, out, {}


# ---------------------------------------------------------------------------------
# embedding / head / loss
# ---------------------------------------------------------------------------------

def embed_tokens(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """The tokens' embeddings (scaled by sqrt(d) in the compute dtype where
    the config says so), with ``prefix_embeds`` [B, P, d] in front."""
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.compute_dtype), x], dim=1)
    return x


def _head_weight(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T         # [D, V]
    return params["head"]


def chunked_xent(params, cfg: ModelConfig, hidden, labels, mask):
    """Cross-entropy over sequence chunks; never holds [B, S, V] logits.

    hidden: [B, S, D]; labels/mask: [B, S].  Returns (loss, n_tokens), the
    masked sum of log-sum-exp minus the label's logit (f32 logits) and the
    mask's sum.  The chunks are the reference's: ``max(S // LOSS_CHUNK,
    1)`` of ``S // n_chunks`` positions, the tail past them cut off; each
    runs under ``maybe_remat``."""
    w = _head_weight(params, cfg)
    S = hidden.shape[1]
    n_chunks = max(S // LOSS_CHUNK, 1)
    csize = S // n_chunks

    def body(h, lab, m):
        logits = (h @ w).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return torch.sum((lse - ll) * m)

    body = maybe_remat(body, cfg)
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * csize, (c + 1) * csize)
        loss = loss + body(hidden[:, sl], labels[:, sl], mask[:, sl])
        n = n + torch.sum(mask[:, sl])
    return loss, n


def last_token_logits(params, cfg: ModelConfig, hidden_last):
    """hidden_last: [B, D] -> [B, V] (f32)."""
    return (hidden_last @ _head_weight(params, cfg)).float()


# ---------------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, batch) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of ``batch["tokens"]`` [B, S] (with
    ``prefix_embeds`` [B, P, d] in front for a patch frontend, whose
    positions carry no label), plus 0.01 times the MoE's load-balance
    loss.  ``params`` are used as given (`convert.working_params` casts a
    master tree).  Returns (loss, {"xent", and for an attention model
    "load_balance_loss"})."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    x = embed_tokens(params, cfg, tokens, prefix)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    prefix_len = (cfg.frontend_len if cfg.prefix_lm and prefix is not None
                  else None)
    hidden, _, aux = _forward_blocks(params, cfg, x, positions, None,
                                     prefix_len)
    hidden = rmsnorm(params["final_norm"], hidden, cfg.rms_eps)
    P = prefix.shape[1] if prefix is not None else 0
    # next-token prediction on the text region
    hid = hidden[:, P:P + tokens.shape[1] - 1]
    labels = tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=x.device)
    loss, n = chunked_xent(params, cfg, hid, labels, mask)
    xent = loss / torch.clamp(n, min=1.0)
    total = xent
    if "load_balance_loss" in aux:
        total = total + 0.01 * aux["load_balance_loss"]
    return total, {"xent": xent, **aux}


def lm_prefill(params, cfg: ModelConfig, batch, capacity: int):
    """Prefill: returns (last-token logits [B,V] f32, caches).  ``batch``
    holds ``tokens`` [B, S] and, for a patch frontend, ``prefix_embeds``."""
    prefix = batch.get("prefix_embeds")
    x = embed_tokens(params, cfg, batch["tokens"], prefix)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    prefix_len = (cfg.frontend_len if cfg.prefix_lm and prefix is not None
                  else None)
    hidden, caches, _ = _forward_blocks(params, cfg, x, positions, capacity,
                                        prefix_len)
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
