"""The time-step recurrences of the recurrent model families on the GPU.

=================  =====================  ====================================
wrapper            plain version          replaces (repro, XLA: no Pallas)
=================  =====================  ====================================
``wkv6_scan``      ``wkv6_scan_plain``    ``models/recurrent.py:114-125``, the
                                          ``lax.scan`` of
                                          ``rwkv_timemix_forward``
``rglru_scan``     ``rglru_scan_plain``   ``models/recurrent.py:205-212`` and
                                          ``:215-236``, the gates of
                                          ``_rglru_gates`` and the
                                          ``lax.associative_scan`` of
                                          ``rglru_block_forward``
=================  =====================  ====================================

The kernels are in ``csrc/recurrent.cu``.  ``wkv6_scan``: one CTA per
(batch, head), the recurrence regrouped by chunks of ``WKV_CHUNK`` steps
(the decay products and the intra-chunk matrix A in f32 on the CUDA cores,
the products Q S, A V and K^T V on the tensor cores as split TF32), the
64 x 64 f32 state in the warps' accumulators; the steps after the last
whole chunk, and so decode's one, run the recurrent step.  ``rglru_scan``:
32 channels a CTA, time split into slices of a chunk of ``RG_CHUNK``
steps whose affine maps compose in shared memory; decode (S = 1) one
thread per (batch, channel).  Each wrapper runs its plain version for
tensors on the CPU and launches its kernel for tensors on a CUDA device;
anything else raises.  Each counts its launches in ``<wrapper>.launches``,
and those at S = 1 also in ``<wrapper>.decode_launches``.

The kernels have no backward yet.  On CUDA tensors each wrapper raises
``NotImplementedError`` where grad mode is on and an input requires grad
(`refuse_autograd`), rather than return outputs without a ``grad_fn``;
CPU tensors go through the plain versions, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: the rwkv head size the WKV kernel is written for
HEAD = 64
#: the rg-lru temperature constant (``repro.models.recurrent.RG_C``)
RG_C = 8.0
#: steps a chunk of the WKV kernel (``WKV_L`` in ``csrc/recurrent.cu``)
WKV_CHUNK = 16
#: steps a chunk of the rg-lru kernel: 8 slices of 4 steps (``RG_CHUNK``)
RG_CHUNK = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _on_cuda(*xs: torch.Tensor) -> bool:
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("the inputs must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def refuse_autograd(name: str, on_cuda: bool, *xs: torch.Tensor) -> None:
    """Raise NotImplementedError for a kernel launch that autograd would
    have to differentiate: ``on_cuda``, grad mode on and an input that
    requires grad.  The scans' backward kernels come with the slice that
    ports them (ROADMAP.md, section 2, items 2 and 3); until then training
    of the recurrent families runs on the CPU."""
    if on_cuda and torch.is_grad_enabled() and any(x.requires_grad
                                                    for x in xs):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet (it comes with the "
            "slice that ports the scans' backward kernels); run without "
            "grad, or on CPU tensors, whose plain version autograd "
            "differentiates")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("recurrent")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_scan_launch.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.wkv6_scan_launch.restype = ci
    lib.rglru_scan_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.rglru_scan_launch.restype = ci
    lib.recurrent_error_string.argtypes = [ci]
    lib.recurrent_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte boundary (cp.async stages rows of 16
    bytes), copied only where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _lib().recurrent_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


# ---------------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------------

def wkv6_scan_plain(r, k, v, w, u, s0):
    """The reference's step, token by token in f32: ``y_t = r_tᵀ (S + u ⊙
    k_t v_tᵀ)`` then ``S = w_t ⊙ S + k_t v_tᵀ`` (u and w_t scale rows).
    Returns (y [B, S, H, hd] f32, the final state)."""
    state = s0.float()
    uu = u.float()[..., :, None]
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = kt[..., :, None] * vt[..., None, :]            # [B, H, hd, hd]
        ys.append(torch.einsum("bhi,bhij->bhj", rt, state + uu * kv))
        state = w[:, t].float()[..., :, None] * state + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros(r.shape, dtype=torch.float32, device=r.device))
    return y, state


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The WKV6 recurrence over S steps.  r, k, v [B, S, H, 64] in the
    compute dtype (f32 or bf16), w [B, S, H, 64] f32 (the decay), u [H, 64]
    f32 (the bonus), s0 [B, H, 64, 64] f32.  Returns (y [B, S, H, 64] f32,
    the final state [B, H, 64, 64] f32)."""
    B, S, H, hd = r.shape
    if (hd != HEAD or k.shape != r.shape or v.shape != r.shape
            or w.shape != r.shape or u.shape != (H, hd)
            or s0.shape != (B, H, hd, hd)):
        raise ValueError(f"wkv6_scan: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)} do not fit [B, S, H, 64]")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("r, k and v must share one dtype, float32 or "
                         f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    on_cuda = _on_cuda(r, k, v, w, u, s0)
    refuse_autograd("wkv6_scan", on_cuda, r, k, v, w, u, s0)
    if not on_cuda:
        return wkv6_scan_plain(r, k, v, w, u, s0)
    if w.dtype != torch.float32 or u.dtype != torch.float32 \
            or s0.dtype != torch.float32:
        raise ValueError("w, u and s0 must be float32")
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    u, s0 = u.contiguous(), s0.contiguous()
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_fin = torch.empty_like(s0)
    if B * H == 0:
        return y, s_fin
    with torch.cuda.device(r.device):
        code = _lib().wkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
            _DTYPE_CODE[r.dtype], B, H, S,
            torch.cuda.current_stream(r.device).cuda_stream)
    _raise_on(code, "wkv6_scan")
    wkv6_scan.launches += 1
    wkv6_scan.decode_launches += int(S == 1)
    return y, s_fin


wkv6_scan.launches = 0
wkv6_scan.decode_launches = 0


# ---------------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------------

def rglru_scan_plain(gr, gi, xc, sp, h0):
    """The reference's ``_rglru_gates`` after its two matrix products, then
    ``h_t = a_t h_{t-1} + b_t`` step by step in f32.  Returns (h [B, S, R]
    f32, h of the last step)."""
    log_a = -RG_C * torch.sigmoid(gr) * sp
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) \
        * (torch.sigmoid(gi) * xc.float())
    h = h0.float()
    hs = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h


def rglru_scan(gr: torch.Tensor, gi: torch.Tensor, xc: torch.Tensor,
               sp: torch.Tensor, h0: torch.Tensor):
    """The RG-LRU gates and recurrence.  gr, gi [B, S, R] f32: the gate
    pre-activations (``x @ w_r + b_r``, ``x @ w_i + b_i``); xc [B, S, R] in
    the compute dtype (the convolution's output); sp [R] f32
    (``softplus(lam)``); h0 [B, R] f32.  Returns (h [B, S, R] f32, h of the
    last step [B, R])."""
    B, S, R = xc.shape
    if (gr.shape != xc.shape or gi.shape != xc.shape or sp.shape != (R,)
            or h0.shape != (B, R)):
        raise ValueError(f"rglru_scan: shapes gr {tuple(gr.shape)}, gi "
                         f"{tuple(gi.shape)}, xc {tuple(xc.shape)}, sp "
                         f"{tuple(sp.shape)}, h0 {tuple(h0.shape)} do not "
                         "fit [B, S, R]")
    if xc.dtype not in _DTYPE_CODE:
        raise ValueError(f"xc must be float32 or bfloat16, not {xc.dtype}")
    on_cuda = _on_cuda(gr, gi, xc, sp, h0)
    refuse_autograd("rglru_scan", on_cuda, gr, gi, xc, sp, h0)
    if not on_cuda:
        return rglru_scan_plain(gr, gi, xc, sp, h0)
    if any(x.dtype != torch.float32 for x in (gr, gi, sp, h0)):
        raise ValueError("gr, gi, sp and h0 must be float32")
    gr, gi, xc, sp, h0 = (x.contiguous() for x in (gr, gi, xc, sp, h0))
    hs = torch.empty((B, S, R), dtype=torch.float32, device=xc.device)
    h_last = torch.empty_like(h0) if S else h0.clone()
    if B * R == 0 or S == 0:
        return hs, h_last
    with torch.cuda.device(xc.device):
        code = _lib().rglru_scan_launch(
            gr.data_ptr(), gi.data_ptr(), xc.data_ptr(), sp.data_ptr(),
            h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(),
            _DTYPE_CODE[xc.dtype], B, S, R,
            torch.cuda.current_stream(xc.device).cuda_stream)
    _raise_on(code, "rglru_scan")
    rglru_scan.launches += 1
    rglru_scan.decode_launches += int(S == 1)
    return hs, h_last


rglru_scan.launches = 0
rglru_scan.decode_launches = 0

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (wkv6_scan, rglru_scan)

__all__ = ["HEAD", "RG_C", "RG_CHUNK", "WKV_CHUNK", "WRAPPERS",
           "refuse_autograd", "rglru_scan", "rglru_scan_plain", "wkv6_scan",
           "wkv6_scan_plain"]
