"""The time-step recurrences of the recurrent model families on the GPU,
and their backward.

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
``wkv6_scan_bwd``  ``wkv6_scan_bwd_       the autodiff of ``:125``
                   plain``
``rglru_scan_bwd`` ``rglru_scan_bwd_      the autodiff of ``:234`` with
                   plain``                ``:205``
=================  =====================  ====================================

The forward kernels are in ``csrc/recurrent.cu``.  ``wkv6_scan``: one CTA
per (batch, head), the recurrence regrouped by chunks of ``WKV_CHUNK``
steps (the decay products and the intra-chunk matrix A in f32 on the CUDA
cores, the products Q S, A V and K^T V on the tensor cores as split TF32),
the 64 x 64 f32 state in the warps' accumulators; the steps after the last
whole chunk, and so decode's one, run the recurrent step.  ``rglru_scan``:
32 channels a CTA, time split into slices of a chunk of ``RG_CHUNK``
steps whose affine maps compose in shared memory; decode (S = 1) one
thread per (batch, channel).

The backward kernels are in ``csrc/recurrent_bwd.cu``.  ``wkv6_scan_bwd``:
one CTA per (batch, head), the forward's chunks of ``WKV_CHUNK`` steps
walked back from the last: the chunk's products (the state's adjoint
carried back, dv, and what dr, dk and dw need of the state and its
adjoint) on the tensor cores as split TF32, then a walk a channel on the
CUDA cores with every decay product built forward (no division, so a
decay of exactly 0 is no fault); the chunks' incoming states come from a
first pass forward that keeps one every segment of chunks, each segment
rebuilt before it is walked back.  ``rglru_scan_bwd``: the adjoint's
reverse recurrence in the forward's slices, each step's gates recomputed
and differentiated as ``jax.vjp`` of the reference's lines does.  Sums
over CTAs (du's and dsp's over the batch) are second passes in a fixed
order: no atomics, every launch bit-identical.

Each wrapper runs its plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device; anything else raises.  Each
counts its launches in ``<wrapper>.launches``, and the forward ones those
at S = 1 also in ``<wrapper>.decode_launches``.  Where grad mode is on and
an input requires grad, ``wkv6_scan`` and ``rglru_scan`` run as the
autograd functions `WKV6Scan` and `RGLRUScan`, whose backward is the
backward wrapper: on CUDA its kernel, on the CPU its plain version (a
step-by-step f32 sweep, not autograd of the plain forward).
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
#: chunks a checkpoint segment of the WKV backward (``WB_M`` in
#: ``csrc/recurrent_bwd.cu``)
WKV_BWD_SEGMENT = 6
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


def _dtypes(on_cuda: bool):
    """The compute dtypes the scans take: the kernels' f32 and bf16, and on
    the CPU also f64 (for ``torch.autograd.gradcheck``)."""
    return tuple(_DTYPE_CODE) + (() if on_cuda else (torch.float64,))


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 where it is f64 (the plain versions'
    arithmetic; f64 for ``torch.autograd.gradcheck``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _needs_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


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


@functools.lru_cache(maxsize=1)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("recurrent_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_scan_bwd_launch.argtypes = [vp] * 16 + [ci] * 4 + [vp]
    lib.wkv6_scan_bwd_launch.restype = ci
    lib.wkv6_scan_bwd_workspace.argtypes = [ci] * 3
    lib.wkv6_scan_bwd_workspace.restype = ctypes.c_longlong
    lib.rglru_scan_bwd_launch.argtypes = [vp] * 14 + [ci] * 4 + [vp]
    lib.rglru_scan_bwd_launch.restype = ci
    lib.recurrent_bwd_error_string.argtypes = [ci]
    lib.recurrent_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte boundary (cp.async stages rows of 16
    bytes), copied only where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _raise_on(code: int, what: str, error_string) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({error_string(code).decode()})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------------

def _wkv6_check(name, r, k, v, w, u, s0) -> bool:
    """Raise on shapes or dtypes the WKV scan does not take; True for CUDA
    tensors."""
    B, S, H, hd = r.shape
    if (hd != HEAD or k.shape != r.shape or v.shape != r.shape
            or w.shape != r.shape or u.shape != (H, hd)
            or s0.shape != (B, H, hd, hd)):
        raise ValueError(f"{name}: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)} do not fit [B, S, H, 64]")
    on_cuda = _on_cuda(r, k, v, w, u, s0)
    if r.dtype not in _dtypes(on_cuda) or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError("r, k and v must share one dtype, float32 or "
                         f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    return on_cuda


def _f32(name: str, **xs: torch.Tensor) -> None:
    bad = [k for k, x in xs.items() if x.dtype != torch.float32]
    if bad:
        raise ValueError(f"{name}: {', '.join(bad)} must be float32")


def wkv6_scan_plain(r, k, v, w, u, s0):
    """The reference's step, token by token in f32: ``y_t = r_tᵀ (S + u ⊙
    k_t v_tᵀ)`` then ``S = w_t ⊙ S + k_t v_tᵀ`` (u and w_t scale rows).
    Returns (y [B, S, H, hd] f32, the final state)."""
    state = _wide(s0)
    uu = _wide(u)[..., :, None]
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = _wide(r[:, t]), _wide(k[:, t]), _wide(v[:, t])
        kv = kt[..., :, None] * vt[..., None, :]            # [B, H, hd, hd]
        ys.append(torch.einsum("bhi,bhij->bhj", rt, state + uu * kv))
        state = _wide(w[:, t])[..., :, None] * state + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros(r.shape, dtype=state.dtype, device=r.device))
    return y, state


def _wkv6_launch(r, k, v, w, u, s0):
    """``wkv6_scan``'s kernel on CUDA tensors (checked by `_wkv6_check`)."""
    _f32("wkv6_scan", w=w, u=u, s0=s0)
    B, S, H, hd = r.shape
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    u, s0 = u.contiguous(), s0.contiguous()
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_fin = torch.empty_like(s0)
    if B * H == 0:
        return y, s_fin
    lib = _lib()
    with torch.cuda.device(r.device):
        code = lib.wkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
            _DTYPE_CODE[r.dtype], B, H, S, _stream(r))
    _raise_on(code, "wkv6_scan", lib.recurrent_error_string)
    wkv6_scan.launches += 1
    wkv6_scan.decode_launches += int(S == 1)
    return y, s_fin


class WKV6Scan(torch.autograd.Function):
    """`wkv6_scan` under autograd: the forward kernel (the plain version
    for CPU tensors), saving its inputs; the backward is `wkv6_scan_bwd`,
    which rebuilds the states from s0."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        if r.device.type == "cuda":
            return _wkv6_launch(r, k, v, w, u, s0)
        return wkv6_scan_plain(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds_fin):
        grads = wkv6_scan_bwd(*ctx.saved_tensors, dy, ds_fin)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """The WKV6 recurrence over S steps.  r, k, v [B, S, H, 64] in the
    compute dtype (f32 or bf16), w [B, S, H, 64] f32 (the decay), u [H, 64]
    f32 (the bonus), s0 [B, H, 64, 64] f32.  Returns (y [B, S, H, 64] f32,
    the final state [B, H, 64, 64] f32).  Where grad mode is on and an
    input requires grad it runs as `WKV6Scan`, differentiable."""
    on_cuda = _wkv6_check("wkv6_scan", r, k, v, w, u, s0)
    if _needs_grad(r, k, v, w, u, s0):
        return WKV6Scan.apply(r, k, v, w, u, s0)
    if not on_cuda:
        return wkv6_scan_plain(r, k, v, w, u, s0)
    return _wkv6_launch(r, k, v, w, u, s0)


wkv6_scan.launches = 0
wkv6_scan.decode_launches = 0


def wkv6_scan_bwd_plain(r, k, v, w, u, s0, dy, ds_fin):
    """The WKV6 backward, step by step in f32 from the states S_{t-1}
    (rebuilt forward from s0) and the state's adjoint G_t, carried back from
    ``ds_fin``: ``dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t · dy_t)``, ``dk_t = G_t
    v_t + r_t ⊙ u (v_t · dy_t)``, ``dv_t = G_tᵀ k_t + (Σ r_t u k_t) dy_t``,
    ``dw_t = Σ_j G_t ⊙ S_{t-1}``, ``du = Σ r_t ⊙ k_t (v_t · dy_t)``, then
    ``G_{t-1} = w_t ⊙ G_t + r_t dy_tᵀ``; ``ds0 = G_{-1}``.  Returns (dr,
    dk, dv in r's dtype, dw, du, ds0)."""
    S = r.shape[1]
    rf, kf, vf, wf, dyf = (_wide(x) for x in (r, k, v, w, dy))
    uf = _wide(u)
    states = [_wide(s0)]                               # states[t] = S_{t-1}
    for t in range(S - 1):
        kv = kf[:, t, ..., :, None] * vf[:, t, ..., None, :]
        states.append(wf[:, t, ..., :, None] * states[-1] + kv)
    G = _wide(ds_fin)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(S)):
        rt, kt, vt, wt, yt = rf[:, t], kf[:, t], vf[:, t], wf[:, t], dyf[:, t]
        sp = states[t]
        vdy = (vt * yt).sum(-1, keepdim=True)           # [B, H, 1]
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, yt) + uf * kt * vdy
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + rt * uf * vdy
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", G, kt)
                    + (rt * uf * kt).sum(-1, keepdim=True) * yt)
        dw[:, t] = (G * sp).sum(-1)
        du += (rt * kt * vdy).sum(0)
        G = wt[..., :, None] * G + rt[..., :, None] * yt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, G)


def wkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  dy: torch.Tensor, ds_fin: torch.Tensor):
    """The gradients (dr, dk, dv, dw, du, ds0) of `wkv6_scan`'s outputs
    (y, the final state) with cotangents ``dy`` [B, S, H, 64] and ``ds_fin``
    [B, H, 64, 64], both f32 (zero where an output is unused).  For CUDA
    tensors one call of ``csrc/recurrent_bwd.cu`` (the chunked sweep,
    then du's sum over the batch), counted once in
    ``wkv6_scan_bwd.launches``;
    for CPU tensors `wkv6_scan_bwd_plain`.  dr, dk, dv come out in r's
    dtype, the rest in f32."""
    on_cuda = _wkv6_check("wkv6_scan_bwd", r, k, v, w, u, s0)
    if dy.shape != r.shape or ds_fin.shape != s0.shape:
        raise ValueError(f"wkv6_scan_bwd: dy {tuple(dy.shape)} and ds_fin "
                         f"{tuple(ds_fin.shape)} do not fit r "
                         f"{tuple(r.shape)} and s0 {tuple(s0.shape)}")
    _on_cuda(r, dy, ds_fin)                 # raises unless on r's device
    if not on_cuda:
        return wkv6_scan_bwd_plain(r, k, v, w, u, s0, dy, ds_fin)
    _f32("wkv6_scan_bwd", w=w, u=u, s0=s0, dy=dy, ds_fin=ds_fin)
    B, S, H, hd = r.shape
    r, k, v, w, dy, u, s0, ds_fin = (_aligned(x) for x in
                                     (r, k, v, w, dy, u, s0, ds_fin))
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dw = torch.empty_like(w)
    du = torch.zeros_like(u)
    ds0 = torch.empty_like(s0)
    if B * H == 0:
        return dr, dk, dv, dw, du, ds0
    lib = _bwd_lib()
    ws = torch.empty(lib.wkv6_scan_bwd_workspace(B, H, S),
                     dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = lib.wkv6_scan_bwd_launch(
            *(x.data_ptr() for x in (r, k, v, w, u, s0, dy, ds_fin, dr, dk,
                                     dv, dw, du, ds0, du_part, ws)),
            _DTYPE_CODE[r.dtype], B, H, S, _stream(r))
    _raise_on(code, "wkv6_scan_bwd", lib.recurrent_bwd_error_string)
    wkv6_scan_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv6_scan_bwd.launches = 0


# ---------------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------------

def _rglru_check(name, gr, gi, xc, sp, h0) -> bool:
    """Raise on shapes or dtypes the RG-LRU scan does not take; True for
    CUDA tensors."""
    B, S, R = xc.shape
    if (gr.shape != xc.shape or gi.shape != xc.shape or sp.shape != (R,)
            or h0.shape != (B, R)):
        raise ValueError(f"{name}: shapes gr {tuple(gr.shape)}, gi "
                         f"{tuple(gi.shape)}, xc {tuple(xc.shape)}, sp "
                         f"{tuple(sp.shape)}, h0 {tuple(h0.shape)} do not "
                         "fit [B, S, R]")
    on_cuda = _on_cuda(gr, gi, xc, sp, h0)
    if xc.dtype not in _dtypes(on_cuda):
        raise ValueError(f"xc must be float32 or bfloat16, not {xc.dtype}")
    return on_cuda


def rglru_scan_plain(gr, gi, xc, sp, h0):
    """The reference's ``_rglru_gates`` after its two matrix products, then
    ``h_t = a_t h_{t-1} + b_t`` step by step in f32.  Returns (h [B, S, R]
    f32, h of the last step)."""
    log_a = -RG_C * torch.sigmoid(gr) * sp
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) \
        * (torch.sigmoid(gi) * _wide(xc))
    h = _wide(h0)
    hs = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h


def _rglru_launch(gr, gi, xc, sp, h0):
    """``rglru_scan``'s kernel on CUDA tensors (checked by
    `_rglru_check`)."""
    _f32("rglru_scan", gr=gr, gi=gi, sp=sp, h0=h0)
    B, S, R = xc.shape
    gr, gi, xc, sp, h0 = (x.contiguous() for x in (gr, gi, xc, sp, h0))
    hs = torch.empty((B, S, R), dtype=torch.float32, device=xc.device)
    h_last = torch.empty_like(h0) if S else h0.clone()
    if B * R == 0 or S == 0:
        return hs, h_last
    lib = _lib()
    with torch.cuda.device(xc.device):
        code = lib.rglru_scan_launch(
            gr.data_ptr(), gi.data_ptr(), xc.data_ptr(), sp.data_ptr(),
            h0.data_ptr(), hs.data_ptr(), h_last.data_ptr(),
            _DTYPE_CODE[xc.dtype], B, S, R, _stream(xc))
    _raise_on(code, "rglru_scan", lib.recurrent_error_string)
    rglru_scan.launches += 1
    rglru_scan.decode_launches += int(S == 1)
    return hs, h_last


class RGLRUScan(torch.autograd.Function):
    """`rglru_scan` under autograd: the forward kernel (the plain version
    for CPU tensors), saving its inputs and its output h; the backward is
    `rglru_scan_bwd`, which reads h_{t-1} from that output."""

    @staticmethod
    def forward(ctx, gr, gi, xc, sp, h0):
        if xc.device.type == "cuda":
            hs, h_last = _rglru_launch(gr, gi, xc, sp, h0)
        else:
            hs, h_last = rglru_scan_plain(gr, gi, xc, sp, h0)
        ctx.save_for_backward(gr, gi, xc, sp, h0, hs)
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        grads = rglru_scan_bwd(*ctx.saved_tensors, dhs, dh_last)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def rglru_scan(gr: torch.Tensor, gi: torch.Tensor, xc: torch.Tensor,
               sp: torch.Tensor, h0: torch.Tensor):
    """The RG-LRU gates and recurrence.  gr, gi [B, S, R] f32: the gate
    pre-activations (``x @ w_r + b_r``, ``x @ w_i + b_i``); xc [B, S, R] in
    the compute dtype (the convolution's output); sp [R] f32
    (``softplus(lam)``); h0 [B, R] f32.  Returns (h [B, S, R] f32, h of the
    last step [B, R]).  Where grad mode is on and an input requires grad
    it runs as `RGLRUScan`, differentiable."""
    on_cuda = _rglru_check("rglru_scan", gr, gi, xc, sp, h0)
    if _needs_grad(gr, gi, xc, sp, h0):
        return RGLRUScan.apply(gr, gi, xc, sp, h0)
    if not on_cuda:
        return rglru_scan_plain(gr, gi, xc, sp, h0)
    return _rglru_launch(gr, gi, xc, sp, h0)


rglru_scan.launches = 0
rglru_scan.decode_launches = 0


def rglru_scan_bwd_plain(gr, gi, xc, sp, h0, hs, dhs, dh_last):
    """The RG-LRU backward in f32: the adjoint of h carried back, ``g_t =
    dhs_t + a_{t+1} g_{t+1}`` from ``g_{S-1} = dhs_{S-1} + dh_last``, ``dh0
    = a_0 g_0``; then each step's gates differentiated as ``jax.vjp`` of the
    reference's ``_rglru_gates`` does, operation for operation (sqrt's slope
    ``0.5 / sqrt(z)``, infinite where ``1 - a²`` is exactly 0; clip as
    ``min(1, max(0, .))``, each with a slope of 1/2 at a tie).  h_{t-1} is
    read from the forward's output ``hs``.  Returns (dgr, dgi, dxc in xc's
    dtype, dsp, dh0)."""
    S = xc.shape[1]
    x = _wide(xc)
    r, i = torch.sigmoid(_wide(gr)), torch.sigmoid(_wide(gi))
    spf = _wide(sp)
    c = -RG_C * r
    log_a = c * spf
    a = torch.exp(log_a)
    e = torch.exp(2.0 * log_a)
    omz = 1.0 - e
    h1 = torch.clamp(omz, min=0.0)
    z = torch.clamp(h1, max=1.0)
    sq = torch.sqrt(z)
    ix = i * x
    g = torch.empty_like(a)
    carry = _wide(dh_last)
    dhsf = _wide(dhs)
    for t in reversed(range(S)):
        g[:, t] = dhsf[:, t] + carry
        carry = a[:, t] * g[:, t]
    h_prev = torch.cat([_wide(h0)[:, None], _wide(hs)[:, :-1]], dim=1)[:, :S]
    ct_a = g * h_prev
    ct_sq = g * ix
    ct_ix = g * sq
    ct_z = ct_sq * (0.5 / sq)
    half = torch.tensor(0.5, dtype=a.dtype)
    one, zero = torch.ones_like(half), torch.zeros_like(half)
    dmin = torch.where(h1 == z, torch.where(z == 1.0, half, one), zero)
    dmax = torch.where(omz == h1, torch.where(h1 == 0.0, half, one), zero)
    ct_omz = (ct_z * dmin) * dmax
    ct_log_a = ct_a * a + (-ct_omz * e) * 2.0
    dgr = (ct_log_a * spf * -RG_C) * (r * (1.0 - r))
    dsp = (ct_log_a * c).sum((0, 1))
    dgi = (ct_ix * x) * (i * (1.0 - i))
    dx = ct_ix * i
    return dgr, dgi, dx.to(xc.dtype), dsp, carry


def rglru_scan_bwd(gr: torch.Tensor, gi: torch.Tensor, xc: torch.Tensor,
                   sp: torch.Tensor, h0: torch.Tensor, hs: torch.Tensor,
                   dhs: torch.Tensor, dh_last: torch.Tensor):
    """The gradients (dgr, dgi, dxc, dsp, dh0) of `rglru_scan`'s outputs
    (h, the last h) with cotangents ``dhs`` [B, S, R] and ``dh_last``
    [B, R], both f32, given the forward's output ``hs``.  For CUDA tensors
    one call of ``csrc/recurrent_bwd.cu`` (the reverse scan with the gates'
    chain rule, then dsp's sum over the batch), counted once in
    ``rglru_scan_bwd.launches``; for CPU tensors `rglru_scan_bwd_plain`.
    dxc comes out in xc's dtype, the rest in f32."""
    on_cuda = _rglru_check("rglru_scan_bwd", gr, gi, xc, sp, h0)
    if hs.shape != xc.shape or dhs.shape != xc.shape \
            or dh_last.shape != h0.shape:
        raise ValueError(f"rglru_scan_bwd: hs {tuple(hs.shape)}, dhs "
                         f"{tuple(dhs.shape)} and dh_last "
                         f"{tuple(dh_last.shape)} do not fit xc "
                         f"{tuple(xc.shape)} and h0 {tuple(h0.shape)}")
    _on_cuda(xc, hs, dhs, dh_last)          # raises unless on xc's device
    if not on_cuda:
        return rglru_scan_bwd_plain(gr, gi, xc, sp, h0, hs, dhs, dh_last)
    _f32("rglru_scan_bwd", gr=gr, gi=gi, sp=sp, h0=h0, hs=hs, dhs=dhs,
         dh_last=dh_last)
    B, S, R = xc.shape
    ins = [x.contiguous() for x in (gr, gi, xc, sp, h0, hs, dhs, dh_last)]
    dgr, dgi = torch.empty_like(ins[0]), torch.empty_like(ins[1])
    dxc = torch.empty_like(ins[2])
    dsp = torch.zeros_like(ins[3])
    if B * R == 0 or S == 0:
        return dgr, dgi, dxc, dsp, ins[7].clone()
    dh0 = torch.empty_like(ins[4])
    dsp_part = torch.empty((B, R), dtype=torch.float32, device=xc.device)
    lib = _bwd_lib()
    with torch.cuda.device(xc.device):
        code = lib.rglru_scan_bwd_launch(
            *(x.data_ptr() for x in (*ins, dgr, dgi, dxc, dsp, dh0,
                                     dsp_part)),
            _DTYPE_CODE[xc.dtype], B, S, R, _stream(xc))
    _raise_on(code, "rglru_scan_bwd", lib.recurrent_bwd_error_string)
    rglru_scan_bwd.launches += 1
    return dgr, dgi, dxc, dsp, dh0


rglru_scan_bwd.launches = 0

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (wkv6_scan, rglru_scan, wkv6_scan_bwd, rglru_scan_bwd)

__all__ = ["HEAD", "RGLRUScan", "RG_C", "RG_CHUNK", "WKV6Scan", "WKV_CHUNK",
           "WKV_BWD_SEGMENT",
           "WRAPPERS", "rglru_scan", "rglru_scan_bwd", "rglru_scan_bwd_plain",
           "rglru_scan_plain", "wkv6_scan", "wkv6_scan_bwd",
           "wkv6_scan_bwd_plain", "wkv6_scan_plain"]
