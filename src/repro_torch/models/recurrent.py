"""Recurrent sequence mixers: RWKV-6 ("Finch") time/channel mix and the
RG-LRU block of RecurrentGemma/Griffin.

The reference runs RWKV-6's WKV recurrence as a sequential ``lax.scan``
and the RG-LRU's diagonal recurrence as a ``lax.associative_scan``, and
trains both through XLA's autodiff; here both go through one kernel
launch each (`repro_torch.kernels.recurrent`: ``wkv6_scan``, and
``rglru_scan``, which also takes the gates' elementwise part), prefill
and decode alike (decode at S = 1).  Under autograd each runs as its
autograd function (``WKV6Scan``, ``RGLRUScan``), whose backward is one
launch of its backward kernel (``wkv6_scan_bwd``, ``rglru_scan_bwd``) and
gives the gradients of the carried state too (``S``; ``h``, and through
the convolution ``conv``; ``x_prev`` through the token shift) where a
caller passes a state that requires grad.  The matrix products around
them stay PyTorch.

Parameters follow the reference's uses: those it applies in f32 (rwkv's
``w0``, ``wd2``, ``u`` and ``gn_scale``; the rg-lru's ``w_r``, ``w_i``,
``b_r``, ``b_i`` and ``lam``) are kept in f32, the rest in the compute
dtype, which is what the reference's ``.astype(compute_dtype)`` at every
use computes (`RWKV_F32`, `RGLRU_F32`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import recurrent as rk

from .common import ModelConfig, dense_init

LORA_R = 32       # rwkv6 ddlerp lora rank
DECAY_R = 64      # rwkv6 decay lora rank

#: the parameters of the rwkv time mix and of the rg-lru block that the
#: reference uses in f32
RWKV_F32 = ("w0", "wd2", "u", "gn_scale")
RGLRU_F32 = ("w_r", "w_i", "b_r", "b_i", "lam")


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


# ===================================================================================
# RWKV-6
# ===================================================================================

def rwkv_heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = rk.HEAD
    return cfg.d_model // hd, hd


def rwkv_timemix_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, cd, dev = cfg.d_model, cfg.compute_dtype, gen.device
    H, hd = rwkv_heads(cfg)
    return {
        "mu_x": torch.zeros((D,), dtype=cd, device=dev),
        "mu": torch.zeros((5, D), dtype=cd, device=dev),   # r,k,v,w,g mixes
        "maa_w1": dense_init(gen, (D, 5 * LORA_R), scale=0.01, dtype=cd),
        "maa_w2": dense_init(gen, (5, LORA_R, D), scale=0.01, dtype=cd),
        "wr": dense_init(gen, (D, D), dtype=cd),
        "wk": dense_init(gen, (D, D), dtype=cd),
        "wv": dense_init(gen, (D, D), dtype=cd),
        "wg": dense_init(gen, (D, D), dtype=cd),
        "wo": dense_init(gen, (D, D), dtype=cd),
        "w0": torch.full((D,), -3.0, device=dev),        # decay bias
        "wd1": dense_init(gen, (D, DECAY_R), scale=0.01, dtype=cd),
        "wd2": dense_init(gen, (DECAY_R, D), scale=0.01),
        "u": dense_init(gen, (H, hd), scale=0.5),         # bonus (time_faaaa)
        "gn_scale": torch.ones((D,), device=dev),        # per-head group norm
    }


def _ddlerp(p, x, xx):
    """Data-dependent token-shift interpolation -> 5 mixed streams [...,5,D]."""
    base = x + xx * p["mu_x"]
    lora = torch.tanh(base @ p["maa_w1"])
    lora = lora.reshape(*lora.shape[:-1], 5, lora.shape[-1] // 5)
    delta = torch.einsum("...fr,frd->...fd", lora, p["maa_w2"])
    mix = p["mu"] + delta                                  # [...,5,D]
    return x[..., None, :] + xx[..., None, :] * mix


def _rwkv_projections(p, cfg: ModelConfig, x, x_prev):
    """r, k, v (compute dtype), w (f32) split into heads, and the gate g."""
    H, hd = rwkv_heads(cfg)
    xx = x_prev - x
    mixed = _ddlerp(p, x, xx)
    xr, xk, xv, xw, xg = (mixed[..., i, :] for i in range(5))
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    dec = torch.tanh(xw @ p["wd1"])
    logw = p["w0"] + dec.float() @ p["wd2"]
    w = torch.exp(-torch.exp(torch.clamp(logw, -10.0, 6.0)))  # decay
    def split(t): return t.reshape(*t.shape[:-1], H, hd)
    return split(r), split(k), split(v), split(w), g


def _groupnorm_heads(scale, y, H, hd, eps=1e-5):
    """Per-head normalization of the wkv output (rwkv's GroupNorm(H))."""
    yf = y.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, unbiased=False, keepdim=True)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    return yn.reshape(*y.shape[:-2], H * hd) * scale.float()


def rwkv_timemix_forward(p, cfg: ModelConfig, x, state=None):
    """Full-sequence forward. x: [B,S,D].  Returns (out, new_state).

    state = {"S": [B,H,hd,hd] f32, "x_prev": [B,D]} (None -> zeros)."""
    B, S, D = x.shape
    H, hd = rwkv_heads(cfg)
    if state is None:
        state = {
            "S": torch.zeros((B, H, hd, hd), device=x.device),
            "x_prev": torch.zeros((B, D), dtype=x.dtype, device=x.device),
        }
    x_shift = torch.cat([state["x_prev"][:, None], x[:, :-1]], dim=1)
    r, k, v, w, g = _rwkv_projections(p, cfg, x, x_shift)
    y, s_fin = rk.wkv6_scan(r, k, v, w, p["u"].float(), state["S"])
    y = _groupnorm_heads(p["gn_scale"], y, H, hd).to(x.dtype)
    return (y * g) @ p["wo"], {"S": s_fin, "x_prev": x[:, -1]}


def rwkv_timemix_decode(p, cfg: ModelConfig, x1, state):
    """Single-token step. x1: [B,D]."""
    H, hd = rwkv_heads(cfg)
    r, k, v, w, g = _rwkv_projections(p, cfg, x1, state["x_prev"])
    y, s_new = rk.wkv6_scan(r[:, None], k[:, None], v[:, None], w[:, None],
                            p["u"].float(), state["S"])
    y = _groupnorm_heads(p["gn_scale"], y, H, hd)[:, 0].to(x1.dtype)
    return (y * g) @ p["wo"], {"S": s_new, "x_prev": x1}


def rwkv_channelmix_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, f, cd, dev = cfg.d_model, cfg.d_ff, cfg.compute_dtype, gen.device
    return {
        "mu_k": torch.zeros((D,), dtype=cd, device=dev),
        "mu_r": torch.zeros((D,), dtype=cd, device=dev),
        "wk": dense_init(gen, (D, f), dtype=cd),
        "wv": dense_init(gen, (f, D), dtype=cd),
        "wr": dense_init(gen, (D, D), dtype=cd),
    }


def rwkv_channelmix(p, cfg: ModelConfig, x, x_prev):
    """x: [..., D]; x_prev: same shape (token-shifted)."""
    xx = x_prev - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])


# ===================================================================================
# RG-LRU (RecurrentGemma / Griffin)
# ===================================================================================

def rglru_block_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, cd, dev = cfg.d_model, cfg.compute_dtype, gen.device
    R = cfg.rnn_width or D
    K = cfg.conv_kernel
    return {
        "w_y": dense_init(gen, (D, R), dtype=cd),
        "w_x": dense_init(gen, (D, R), dtype=cd),
        "conv_w": dense_init(gen, (K, R), scale=K ** -0.5, dtype=cd),
        "conv_b": torch.zeros((R,), dtype=cd, device=dev),
        "w_r": dense_init(gen, (R, R), scale=0.01),
        "b_r": torch.zeros((R,), device=dev),
        "w_i": dense_init(gen, (R, R), scale=0.01),
        "b_i": torch.zeros((R,), device=dev),
        "lam": torch.full((R,), 3.0, device=dev),  # sigma(3) ~ .95 slow decay
        "w_out": dense_init(gen, (R, D), dtype=cd),
    }


def _causal_conv(w, b, x, prev):
    """Depthwise causal conv1d.  x: [B,S,R]; prev: [B,K-1,R] carried state.
    The taps are summed in the reference's order (``sum`` from tap 0)."""
    K = w.shape[0]
    full = torch.cat([prev, x], dim=1)                      # [B, S+K-1, R]
    S = x.shape[1]
    out = full[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + full[:, i:i + S] * w[i]
    return out + b, full[:, full.shape[1] - (K - 1):]


def _gate_inputs(p, xc):
    """The f32 gate pre-activations and softplus(lam) (``logaddexp(lam, 0)``
    as ``jax.nn.softplus``) that ``rglru_scan`` takes."""
    xf = xc.float()
    lam = p["lam"].float()
    return (xf @ p["w_r"].float() + p["b_r"], xf @ p["w_i"].float() + p["b_i"],
            torch.logaddexp(lam, torch.zeros_like(lam)))


def rglru_block_forward(p, cfg: ModelConfig, x, state=None):
    """Full-sequence Griffin recurrent block.  x: [B,S,D]."""
    B, S, D = x.shape
    R = cfg.rnn_width or D
    K = cfg.conv_kernel
    if state is None:
        state = {
            "h": torch.zeros((B, R), device=x.device),
            "conv": torch.zeros((B, K - 1, R), dtype=x.dtype,
                                device=x.device),
        }
    y = _gelu(x @ p["w_y"])
    xb = x @ p["w_x"]
    xc, conv_state = _causal_conv(p["conv_w"], p["conv_b"], xb, state["conv"])
    gr, gi, sp = _gate_inputs(p, xc)
    h, h_last = rk.rglru_scan(gr, gi, xc, sp, state["h"])
    out = (h.to(x.dtype) * y) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_state}


def rglru_block_decode(p, cfg: ModelConfig, x1, state):
    """Single-token step. x1: [B,D]."""
    y = _gelu(x1 @ p["w_y"])
    xb = x1 @ p["w_x"]
    K = p["conv_w"].shape[0]
    window = torch.cat([state["conv"], xb[:, None]], dim=1)  # [B,K,R]
    xc = window[:, 0] * p["conv_w"][0]
    for i in range(1, K):
        xc = xc + window[:, i] * p["conv_w"][i]
    xc = xc + p["conv_b"]
    gr, gi, sp = _gate_inputs(p, xc[:, None])
    _, h = rk.rglru_scan(gr, gi, xc[:, None], sp, state["h"])
    out = (h.to(x1.dtype) * y) @ p["w_out"]
    return out, {"h": h, "conv": window[:, 1:]}
