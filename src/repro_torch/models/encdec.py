"""Encoder-decoder backbone (seamless-m4t-medium class).

The modality frontend is a stub, as in the reference: the batch holds
precomputed frame embeddings ``frames`` [B, S_enc, d] for the encoder.  The
encoder's self-attention is bidirectional; the decoder is a causal stack
with cross-attention to the encoder's memory (keys and values not
rotated).  Every full-sequence attention, the three kinds, goes through
the flash-attention kernel (`attention.attn_forward`).

Layers are lists of per-layer dicts run in a Python loop (the reference
stacks them and runs ``lax.scan``).  Serving keeps one cache a decoder
layer, ``{"self": kv cache, "cross_k": [B, S_enc, K, hd], "cross_v": ...}``:
the cross K/V are computed once at prefill, and a decode step projects only
its query against them (`attention._gqa_attend`, every key allowed).
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import ffn
from .common import ModelConfig, Params, embed_init, rmsnorm, rmsnorm_init
from .lm import last_token_logits


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "attn": attn.attn_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, dev),
        "mlp": ffn.mlp_init(gen, cfg),
    }


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "self_attn": attn.attn_init(gen, cfg),
        "ln_x": rmsnorm_init(cfg.d_model, dev),
        "cross_attn": attn.attn_init(gen, cfg),
        "ln2": rmsnorm_init(cfg.d_model, dev),
        "mlp": ffn.mlp_init(gen, cfg),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Seeded random weights on the generator's device: matrices in the
    compute dtype, norm scales in f32; the head is untied [d, V]."""
    cd, dev = cfg.compute_dtype, gen.device
    return {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype=cd),
        "encoder": [_enc_block_init(gen, cfg) for _ in range(cfg.enc_layers)],
        "decoder": [_dec_block_init(gen, cfg) for _ in range(cfg.dec_layers)],
        "enc_norm": rmsnorm_init(cfg.d_model, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
        "head": embed_init(gen, cfg.vocab, cfg.d_model,
                           dtype=cd).T.contiguous(),
    }


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None]


def encode(params, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames: [B, S_enc, d] stub embeddings -> encoder memory [B, S_enc, d]."""
    x = frames.to(cfg.compute_dtype)
    positions = _positions(x.shape[1], x.device)
    for bp in params["encoder"]:
        h, _ = attn.attn_forward(bp["attn"], cfg,
                                 rmsnorm(bp["ln1"], x, cfg.rms_eps),
                                 positions=positions, causal=False)
        x = x + h
        x = x + ffn.mlp_apply(bp["mlp"], cfg,
                              rmsnorm(bp["ln2"], x, cfg.rms_eps))
    return rmsnorm(params["enc_norm"], x, cfg.rms_eps)


def _decoder_blocks(params, cfg: ModelConfig, x, memory, capacity=None):
    """The decoder over x [B, S, d] against ``memory``.  Returns (hidden,
    caches), the caches None unless ``capacity`` is given."""
    positions = _positions(x.shape[1], x.device)
    caches = []
    for bp in params["decoder"]:
        h, (k, v) = attn.attn_forward(bp["self_attn"], cfg,
                                      rmsnorm(bp["ln1"], x, cfg.rms_eps),
                                      positions=positions, causal=True)
        x = x + h
        h, (ck, cv) = attn.attn_forward(bp["cross_attn"], cfg,
                                        rmsnorm(bp["ln_x"], x, cfg.rms_eps),
                                        positions=positions, kv_x=memory,
                                        use_rope=False, causal=False)
        x = x + h
        x = x + ffn.mlp_apply(bp["mlp"], cfg,
                              rmsnorm(bp["ln2"], x, cfg.rms_eps))
        if capacity is not None:
            cache = attn.init_cache(cfg, x.shape[0], capacity, device=x.device)
            caches.append({"self": attn.fill_cache(cache, k, v, positions[0]),
                           "cross_k": ck, "cross_v": cv})
    return x, (caches if capacity is not None else None)


def encdec_prefill(params, cfg: ModelConfig, batch, capacity: int):
    """batch: {"frames": [B, S_enc, d], "tokens": [B, S]}.  Returns
    (last-token logits [B, V] f32, caches incl. the cross-attention K/V)."""
    memory = encode(params, cfg, batch["frames"])
    x = params["embed"][batch["tokens"]]
    hidden, caches = _decoder_blocks(params, cfg, x, memory, capacity)
    hidden = rmsnorm(params["final_norm"], hidden, cfg.rms_eps)
    return last_token_logits(params, cfg, hidden[:, -1]), caches


def encdec_decode_step(params, cfg: ModelConfig, caches, token, pos: int):
    """One decoder token against the cached self K/V (updated in place)
    and the cross K/V.  token: [B] int, pos: int.  Returns (logits [B, V]
    f32, caches)."""
    x1 = params["embed"][token[:, None]]                 # [B, 1, d]
    for bp, cache in zip(params["decoder"], caches):
        h, _ = attn.attn_decode(bp["self_attn"], cfg,
                                rmsnorm(bp["ln1"], x1, cfg.rms_eps),
                                cache["self"], pos)
        x1 = x1 + h
        # cross-attention against the static memory K/V: no rope, no update
        q = attn._project_q(bp["cross_attn"], cfg,
                            rmsnorm(bp["ln_x"], x1, cfg.rms_eps))
        every = torch.ones((1, 1, 1, 1, cache["cross_k"].shape[1]),
                           dtype=torch.bool, device=x1.device)
        x1 = x1 + attn._gqa_attend(bp["cross_attn"], cfg, q, cache["cross_k"],
                                   cache["cross_v"], every)
        x1 = x1 + ffn.mlp_apply(bp["mlp"], cfg,
                                rmsnorm(bp["ln2"], x1, cfg.rms_eps))
    x1 = rmsnorm(params["final_norm"], x1, cfg.rms_eps)
    return last_token_logits(params, cfg, x1[:, 0]), caches
