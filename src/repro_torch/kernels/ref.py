"""Unblocked PyTorch oracle of the flash-attention kernel.

Counterpart of ``repro.kernels.ref.mha_ref``: the whole score matrix at
once, scores in q's dtype before the f32 scale, probabilities rounded to v's
dtype for the P V product.  Holds ``flash_attention_plain`` in the tests.
"""
from __future__ import annotations

import torch


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int | None = None,
            prefix_len: int | None = None) -> torch.Tensor:
    """q [B,H,Sq,d], k/v [B,K,Sk,d] -> [B,H,Sq,d]; the window and the
    prefix-LM block (rows below ``prefix_len`` see every key below it)
    apply only with the causal mask, as in the reference's ``make_mask``."""
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, K, H // K, Sq, d)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k).float() * (d ** -0.5)
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        mask = cols <= rows
        if window is not None:
            mask = mask & ((rows - cols) < window)
        if prefix_len is not None:
            mask = mask | ((rows < prefix_len) & (cols < prefix_len))
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs.to(v.dtype), v)
    return out.reshape(B, H, Sq, d)
