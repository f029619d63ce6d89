"""GQA/MQA attention with RoPE, optional QKV-bias / qk-norm / sliding window.

Every family's attention: llama3 / qwen / mixtral GQA (n_kv < n_heads),
MHA and the MQA of recurrentgemma and paligemma, qwen1.5/qwen2 QKV bias,
qwen3 / olmoe qk-RMSNorm, the sliding window (mixtral's, recurrentgemma's
local attention), paligemma's prefix-LM mask, and seamless's bidirectional
encoder self-attention and cross-attention (keys and values from the
encoder's memory, not rotated).  Every full-sequence attention goes
through the flash-attention kernel (K4,
`repro_torch.kernels.ops.flash_attention`), which takes every mask the
reference's query-chunked ``_gqa_attend_chunked`` takes: that function has
no counterpart of its own here.  Only the one-token decode against the
cache stays plain PyTorch (`_gqa_attend`).

Serving uses a unified cache: K is stored pre-rotated at absolute positions;
``abs`` tracks each slot's absolute position (-1 = empty), which makes full
and ring-buffer (windowed) caches the same code path.  The port updates a
cache in place where the reference donates it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .common import ModelConfig, apply_rope, dense_init, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Matrices and biases in the compute dtype, norm scales in f32."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    cd, dev = cfg.compute_dtype, gen.device
    p = {
        "wq": dense_init(gen, (d, H, hd), dtype=cd),
        "wk": dense_init(gen, (d, K, hd), dtype=cd),
        "wv": dense_init(gen, (d, K, hd), dtype=cd),
        "wo": dense_init(gen, (H, hd, d), scale=(H * hd) ** -0.5, dtype=cd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=cd, device=dev)
        p["bk"] = torch.zeros((K, hd), dtype=cd, device=dev)
        p["bv"] = torch.zeros((K, hd), dtype=cd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), device=dev)}
        p["k_norm"] = {"scale": torch.ones((hd,), device=dev)}
    return p


def _project_q(p, cfg: ModelConfig, x):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.rms_eps)
    return q


def _project_qkv(p, cfg: ModelConfig, x, kv_x=None):
    """q from ``x``; k and v from ``kv_x`` (cross-attention), else ``x``."""
    kv_x = x if kv_x is None else kv_x
    q = _project_q(p, cfg, x)
    k = torch.einsum("bsd,dke->bske", kv_x, p["wk"])
    v = torch.einsum("bsd,dke->bske", kv_x, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.rms_eps)
    return q, k, v


def _gqa_attend(p, cfg: ModelConfig, q, k, v, mask):
    """q: [B,S,H,hd]  k,v: [B,T,K,hd]  mask: bool broadcastable [B,1,1,S,T].

    Scores, softmax and P V are taken in f32 and the output is rounded to
    the compute dtype once, as the flash-attention kernel computes them;
    the reference's einsums round the scores and the probabilities to the
    compute dtype.  In bf16 those roundings put a decode step far off a
    prefill of the same tokens through the kernel: up to 0.5 on a logit of
    the smoke llama, and fully apart by 4 layers at llama3.2-1b's width."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    out = out.reshape(B, S, H, hd).to(cfg.compute_dtype)
    return torch.einsum("bshd,hde->bse", out, p["wo"])


# ---------------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------------

def make_mask(s_q: int, s_k: int, *, causal: bool, window: int | None = None,
              prefix_len: int | None = None, device=None) -> torch.Tensor:
    """bool[1,1,1,s_q,s_k] — True where attention is allowed."""
    rows = torch.arange(s_q, device=device)[:, None]
    cols = torch.arange(s_k, device=device)[None, :]
    if causal:
        m = cols <= rows
        if window is not None:
            m = m & ((rows - cols) < window)
        if prefix_len is not None:
            m = m | ((rows < prefix_len) & (cols < prefix_len))
    else:
        m = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    return m[None, None, None]


# ---------------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------------

def attn_forward(p, cfg: ModelConfig, x, *, positions, kv_x=None,
                 kv_positions=None, use_rope: bool = True, causal: bool = True,
                 window: int | None = None, prefix_len: int | None = None):
    """Returns (out [B,Sq,d], (k, v) [B,Sk,K,hd], rotated if ``use_rope``).

    k and v come from ``kv_x`` (cross-attention; rotated at
    ``kv_positions``, default ``positions``), else from ``x``.  The mask is
    ``make_mask``'s: causal with an optional window and prefix-LM block, or
    bidirectional.  Every mask goes through the flash-attention kernel on
    [B, heads, S, hd] views of the projections."""
    q, k, v = _project_qkv(p, cfg, x, kv_x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions if kv_positions is None else kv_positions,
                       cfg.rope_theta)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            prefix_len=prefix_len)
    return torch.einsum("bhsd,hde->bse", o, p["wo"]), (k, v)


# ---------------------------------------------------------------------------------
# serving cache
# ---------------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> dict:
    shape = (batch, capacity, cfg.n_kv, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "abs": torch.full((capacity,), -1, dtype=torch.int32, device=device),
    }


def fill_cache(cache: dict, k, v, positions) -> dict:
    """Write a prefill's rotated K/V into the cache, in place (assumes the
    positions are the trailing ones if the window wrapped)."""
    W = cache["k"].shape[1]
    if k.shape[1] > W:  # windowed cache: keep only the last W tokens
        k, v = k[:, -W:], v[:, -W:]
        positions = positions[-W:]
    idx = (positions % W).long()
    cache["k"][:, idx] = k
    cache["v"][:, idx] = v
    cache["abs"][idx] = positions.to(torch.int32)
    return cache


def attn_decode(p, cfg: ModelConfig, x, cache: dict, pos: int, *,
                window: int | None = None, use_rope: bool = True):
    """One decode step (x [B,1,d], pos the new token's absolute position);
    returns (out [B,1,d], cache updated in place)."""
    q, k_new, v_new = _project_qkv(p, cfg, x)
    if use_rope:
        posv = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k_new = apply_rope(k_new, posv, cfg.rope_theta)
    W = cache["k"].shape[1]
    idx = pos % W
    cache["k"][:, idx] = k_new[:, 0]
    cache["v"][:, idx] = v_new[:, 0]
    cache["abs"][idx] = pos
    dist = pos - cache["abs"]                              # [W]
    valid = (cache["abs"] >= 0) & (dist >= 0)
    if window is not None:
        valid = valid & (dist < window)
    mask = valid[None, None, None, None, :]                # [1,1,1,1,W]
    out = _gqa_attend(p, cfg, q, cache["k"], cache["v"], mask)
    return out, cache
