"""Blocked causal / sliding-window GQA attention (K4) on the GPU.

The prefill attention of the serving path.  ``flash_attention`` launches the
hand-written CUDA kernel of ``csrc/flash_attention.cu`` for CUDA tensors and
runs ``flash_attention_plain`` for CPU tensors; anything else raises.  It
counts its kernel launches in ``flash_attention.launches``.

=====================  =========================  =================================
wrapper                plain version              replaces
=====================  =========================  =================================
``flash_attention``    ``flash_attention_plain``  ``repro.kernels.flash_attention``
=====================  =========================  =================================

Layout as the reference: q ``[B, H, Sq, d]``, k and v ``[B, K, Sk, d]`` with
head h reading KV head ``h // (H // K)``; the output is a new contiguous
``[B, H, Sq, d]`` tensor in q's dtype.  The inputs may be strided views
(e.g. ``x.transpose(1, 2)`` of a ``[B, S, H, d]`` projection) as long as the
last dimension is contiguous.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

#: masked score: finite, as in the reference (a fully masked tile must not
#: give exp(-inf + inf))
NEG_INF = -1e30
#: q rows and KV rows per block of the kernel and of the plain version
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(d: int) -> float:
    """d^-0.5 rounded to f32, the scale the kernel multiplies by."""
    return float(np.float32(d ** -0.5))


def _kv_range(q0: int, sk: int, causal: bool, window: int | None,
              block_q: int, block_k: int) -> tuple[int, int]:
    hi = min(sk, q0 + block_q) if causal else sk
    lo = (max(0, q0 - (window - 1)) // block_k) * block_k if window else 0
    return lo, hi


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          block_q: int = BLOCK_Q, block_k: int = BLOCK_K
                          ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its arithmetic: the same
    blocked loop and bounds, the finite sentinel, the f32 online softmax,
    for bf16 inputs P carried as bf16 hi + lo parts (a 16-bit mantissa) in
    P V, and ``acc / max(l, 1e-30)`` cast to q's dtype."""
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = _scale(d)
    split_p = q.dtype == torch.bfloat16
    out = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
    kf, vf = k.float(), v.float()
    for q0 in range(0, Sq, block_q):
        n = min(block_q, Sq - q0)
        # [B, K, G * n, d]: head h = kh * G + g, row index g * n + i
        qb = q[:, :, q0:q0 + n].float().reshape(B, K, G * n, d)
        rows = (q0 + torch.arange(n, device=q.device)).repeat(G)[:, None]
        m = torch.full((B, K, G * n, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, G * n, d), device=q.device)
        lo, hi = _kv_range(q0, Sk, causal, window, block_q, block_k)
        for k0 in range(lo, hi, block_k):
            pad = (0, 0, 0, max(0, k0 + block_k - Sk))   # zero rows past Sk
            kb = torch.nn.functional.pad(kf[:, :, k0:k0 + block_k], pad)
            vb = torch.nn.functional.pad(vf[:, :, k0:k0 + block_k], pad)
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            cols = k0 + torch.arange(block_k, device=q.device)[None, :]
            mask = cols < Sk
            if causal:
                mask = mask & (cols <= rows)
            if window:
                mask = mask & ((rows - cols) < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            if split_p:
                hi = p.to(torch.bfloat16).float()
                p = hi + (p - hi).to(torch.bfloat16).float()
            acc = alpha * acc + torch.matmul(p, vb)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)
        out[:, :, q0:q0 + n] = o.reshape(B, H, n, d).to(q.dtype)
    return out


# ---------------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------------

def _checked(q, k, v, window) -> bool:
    """Validate the inputs; returns whether they lie on CUDA."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: [B, H, Sq, d] and "
                         "[B, K, Sk, d]")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B,H,Sq,d] / "
                         "[B,K,Sk,d]")
    if k.shape[1] == 0 or H % k.shape[1] != 0:
        raise ValueError(f"{H} query heads do not divide into {k.shape[1]} "
                         "KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cuda"


def _aligned(x: torch.Tensor) -> bool:
    """16-byte rows: contiguous last dim, aligned base and row strides."""
    es = x.element_size()
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all((x.stride(i) * es) % 16 == 0 for i in range(3)))


def check_kernel_inputs(q, k, v) -> None:
    """What the kernel takes beyond `_checked`: a head dimension it is
    instantiated for, 16-byte aligned rows, B * H within the grid."""
    B, H, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dimension {d} has no kernel; supported: "
                         f"{HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _aligned(x):
            raise ValueError(f"{name} must have a contiguous last dimension "
                             "and 16-byte aligned rows")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's y limit")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [ci] * 7 + [cl] * 9 + [ci, ci, ctypes.c_float, vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """softmax(mask(q kᵀ d^-0.5)) v per head, [B, H, Sq, d] in q's dtype.
    Counterpart of ``repro.kernels.flash_attention.flash_attention``.

    The kernel takes head dimensions 16, 32, 64 and 128 (every dense
    config's at full width); CPU tensors of any head dimension go to the
    plain version."""
    if not _checked(q, k, v, window):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    check_kernel_inputs(q, k, v)
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    out = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, K, Sq, Sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window or 0), _scale(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {code} "
                           f"({msg})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
