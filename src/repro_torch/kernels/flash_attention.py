"""Blocked causal / sliding-window / prefix-LM / bidirectional GQA attention
(K4) on the GPU.

Every full-sequence attention of the serving path: the causal prefill
(with a sliding window where the model has one), the prefix-LM prefill of a
patch-prefix model (a causal mask plus a bidirectional block over the first
``prefix_len`` positions, the reference's ``make_mask``), and an
encoder-decoder's bidirectional encoder and cross-attention (``causal=False``,
Sq and Sk free).  ``flash_attention`` launches the
hand-written CUDA kernel of ``csrc/flash_attention.cu`` for CUDA tensors and
runs ``flash_attention_plain`` for CPU tensors; anything else raises.  It
counts its kernel launches in ``flash_attention.launches``.

=====================  =========================  =================================
wrapper                plain version              replaces
=====================  =========================  =================================
``flash_attention``    ``flash_attention_plain``  ``repro.kernels.flash_attention``
                                                  and, for every mask it takes,
                                                  ``repro.models.attention.``
                                                  ``_gqa_attend_chunked``
=====================  =========================  =================================

Beside ``flash_attention.launches`` it counts the launches with each
non-causal or prefixed mask in ``flash_attention.bidirectional_launches``
and ``flash_attention.prefix_launches``, and those that wrote each row's
log-sum-exp for a backward in ``flash_attention.lse_launches``.

Training differentiates through it: where grad mode is on and q, k or v
requires grad, ``flash_attention`` runs as the autograd function
``FlashAttention``, whose forward launches the same kernel with its
log-sum-exp output (f32 ``[B, H, Sq]``, natural units: log Σ exp of the
scaled, masked scores) and whose backward is ``flash_attention_bwd``: the
hand-written kernels of ``csrc/flash_attention_bwd.cu`` for CUDA tensors
(counted in ``flash_attention_bwd.launches``), ``flash_attention_bwd_plain``
for CPU tensors.  The reference has no backward of its Pallas kernel: its
training differentiates the XLA attention, which the CPU tests hold these
gradients to.  Without grad (the serving path, under inference mode) the
kernel writes no log-sum-exp.

Layout as the reference: q ``[B, H, Sq, d]``, k and v ``[B, K, Sk, d]`` with
head h reading KV head ``h // (H // K)``; the output is a new contiguous
``[B, H, Sq, d]`` tensor in q's dtype.  The inputs may be strided views
(e.g. ``x.transpose(1, 2)`` of a ``[B, S, H, d]`` projection) as long as the
last dimension is contiguous.

The bf16 kernel reads its tiles through TMA tensor maps, which the C
launcher encodes from the rows ``tensor_map`` computes here (dims, byte
strides, box, swizzle); ``tile_needs_mask`` is the kernel's test for the
tiles that need the per-element mask.  Both are plain Python, so the CPU
tests hold them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

#: masked score: finite, as in the reference (a fully masked tile must not
#: give exp(-inf + inf))
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
LOG2E = float(np.float32(math.log2(math.e)))
LN2 = float(np.float32(math.log(2.0)))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: rows of the consumer warpgroup that owns a slice of a bf16 q block
CONSUMER_ROWS = 64
#: the fields of one tensor-map row, as the C launcher reads them
MAP_FIELDS = ("d", "S", "heads", "B", "row_bytes", "head_bytes",
              "batch_bytes", "box_cols", "box_rows", "swizzle")


def block_shape(d: int, dtype: torch.dtype) -> tuple[int, int]:
    """(q rows, KV rows) of a block of the kernel, and so of the plain
    version's loop: bf16 takes 128 q rows (two consumer warpgroups of 64)
    and KV tiles of 128 rows, 64 at d = 128 and 32 at d = 256 (registers);
    f32 runs on the CUDA cores in 64 x 64 blocks."""
    if dtype == torch.bfloat16:
        return 2 * CONSUMER_ROWS, {128: 64, 256: 32}.get(d, 128)
    return 64, 64


def _scale(d: int, dtype: torch.dtype = torch.float32) -> float:
    """The f32 factor the kernel multiplies scores by: d^-0.5, and for bf16
    d^-0.5 log2(e) (the bf16 kernel's softmax runs in log2 units, on the
    SFU's 2^x)."""
    scale = np.float32(d ** -0.5)
    if dtype == torch.bfloat16:
        scale = scale * np.float32(np.log2(np.e))
    return float(scale)


def _prefix(causal: bool, prefix_len: int | None) -> int:
    """P of the prefix-LM mask as the kernel takes it: 0 for none, and 0
    unless causal (a bidirectional mask allows every key already)."""
    return (prefix_len or 0) if causal else 0


def _kv_range(q0: int, sk: int, causal: bool, window: int | None,
              block_q: int, block_k: int,
              prefix_len: int | None = None) -> tuple[int, int]:
    """The KV tiles [lo, hi) the q block from q0 walks: every allowed key
    of its rows.  A block that starts below P reaches min(Sk, P) and, with
    a window, starts at 0."""
    pre = _prefix(causal, prefix_len)
    in_prefix = q0 < pre
    if causal:
        hi = min(sk, max(q0 + block_q, pre) if in_prefix else q0 + block_q)
    else:
        hi = sk
    lo = 0
    if window and not in_prefix:
        lo = (max(0, q0 - (window - 1)) // block_k) * block_k
    return lo, hi


def tile_needs_mask(r0: int, k0: int, block_k: int, sk: int, causal: bool,
                    window: int | None, rows: int = CONSUMER_ROWS,
                    prefix_len: int | None = None) -> bool:
    """Whether q rows [r0, r0 + rows) against keys [k0, k0 + block_k) need
    the per-element mask: some key lies past Sk, past P for a row below P,
    or, for a row at or past P, above the causal diagonal or outside the
    window.  Where it is False every element is allowed."""
    pre = _prefix(causal, prefix_len)
    needs = k0 + block_k > sk
    if r0 < pre:
        needs = needs or k0 + block_k > pre
    if r0 + rows - 1 >= pre:
        needs = needs or (causal and k0 + block_k - 1 > max(r0, pre)) or (
            bool(window) and r0 + rows - 1 - k0 >= window)
    return needs


def tensor_map(x: torch.Tensor, box_rows: int) -> tuple[int, ...]:
    """One row of the launcher's tensor-map table for a [B, heads, S, d]
    view: dims (d, S, heads, B) innermost first, the byte strides of S,
    heads and B, the box (columns, rows) and the swizzle in bytes.

    A bf16 box is at most 64 columns (128 bytes; d = 128 takes two, d = 256
    four) with a swizzle as wide as its row: 128B at d >= 64, 64B at
    d = 32, 32B at d = 16.  f32 tensors get no box (the f32 kernel reads by pointer and
    takes only the strides).  Raises ValueError on what TMA cannot take: a
    base that is not 16-byte aligned, a last dimension that is not
    contiguous, byte strides that are not multiples of 16 or reach 2^40,
    dims of 0 or of 2^32 and more.  A dimension of size 1 is never
    stepped, so its stride is given as 16."""
    shape, stride = x.shape, x.stride()
    B, heads, S, d = shape
    es = x.element_size()
    if stride[3] != 1:
        raise ValueError("the last dimension must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("the base address must be 16-byte aligned")
    if not all(0 < n < 2 ** 32 for n in shape):
        raise ValueError(f"dims {tuple(shape)} must lie in [1, 2^32)")
    strides = []
    for dim in (2, 1, 0):
        nbytes = stride[dim] * es if shape[dim] > 1 else 16
        if nbytes % 16 or not 0 < nbytes < 2 ** 40:
            raise ValueError(f"byte stride {nbytes} of dim {dim} must be a "
                             "positive multiple of 16 below 2^40")
        strides.append(nbytes)
    box = (0, 0, 0)
    if x.dtype == torch.bfloat16:
        span = min(d, 64)
        box = (span, box_rows, 2 * span)
    return (d, S, heads, B, *strides, *box)


def _q_range(k0: int, sq: int, sk: int, causal: bool, window: int | None,
             block_q: int, block_k: int,
             prefix_len: int | None = None) -> tuple[int, int]:
    """The q rows [lo, hi) that see the KV tile [k0, k0 + block_k): the
    transpose of `_kv_range`, with lo rounded down to a q block.  Causal,
    rows from k0 on see it, and with a window only rows below
    kmax + window (kmax the tile's last key below Sk); a tile that starts
    below P is also seen by every row below P, so its rows start at 0."""
    pre = _prefix(causal, prefix_len)
    kmax = min(k0 + block_k, sk) - 1
    in_prefix = k0 < pre
    lo = k0 if causal and not in_prefix else 0
    hi = sq
    if window:
        hi = min(sq, max(pre, kmax + window) if in_prefix else kmax + window)
    return (lo // block_q) * block_q, hi


def _allowed(rows: torch.Tensor, cols: torch.Tensor, sk: int, causal: bool,
             window: int | None, pre: int) -> torch.Tensor:
    """The kernel's mask of (row, key) pairs (`allowed` in the sources)."""
    mask = (cols <= rows) if causal else (cols >= 0)
    if window:
        mask = mask & ((rows - cols) < window)
    if pre:
        mask = mask | ((rows < pre) & (cols < pre))
    return mask & (cols < sk)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          prefix_len: int | None = None,
                          block_q: int | None = None,
                          block_k: int | None = None,
                          return_lse: bool = False):
    """Plain PyTorch version of the kernel, with its arithmetic: the same
    blocked loop and bounds (``block_shape`` unless given), the finite
    sentinel, the f32 online softmax, for bf16 inputs the softmax in log2
    units (2^(s log2(e) - m log2(e)) = e^(s - m)) and P carried as bf16
    hi + lo parts (a 16-bit mantissa) in P V, and ``acc / max(l, 1e-30)``
    cast to q's dtype.  ``prefix_len`` P (causal only): rows below P also
    attend to every key below P.  With ``return_lse`` it returns (out,
    lse): each row's m + log(max(l, 1e-30)) in natural units, f32
    ``[B, H, Sq]`` (bf16: (m + log2(max(l, 1e-30))) ln 2, as the kernel
    writes it)."""
    B, H, Sq, d = q.shape
    bq, bk = block_shape(d, q.dtype)
    block_q, block_k = block_q or bq, block_k or bk
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    pre = _prefix(causal, prefix_len)
    scale = _scale(d, q.dtype)
    split_p = q.dtype == torch.bfloat16
    exp = torch.exp2 if split_p else torch.exp
    out = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    kf, vf = k.float(), v.float()
    for q0 in range(0, Sq, block_q):
        n = min(block_q, Sq - q0)
        # [B, K, G * n, d]: head h = kh * G + g, row index g * n + i
        qb = q[:, :, q0:q0 + n].float().reshape(B, K, G * n, d)
        rows = (q0 + torch.arange(n, device=q.device)).repeat(G)[:, None]
        m = torch.full((B, K, G * n, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, G * n, d), device=q.device)
        lo, hi = _kv_range(q0, Sk, causal, window, block_q, block_k, pre)
        for k0 in range(lo, hi, block_k):
            pad = (0, 0, 0, max(0, k0 + block_k - Sk))   # zero rows past Sk
            kb = torch.nn.functional.pad(kf[:, :, k0:k0 + block_k], pad)
            vb = torch.nn.functional.pad(vf[:, :, k0:k0 + block_k], pad)
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            cols = k0 + torch.arange(block_k, device=q.device)[None, :]
            s = torch.where(_allowed(rows, cols, Sk, causal, window, pre), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = exp(s - m_new)
            alpha = exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            if split_p:
                hi = p.to(torch.bfloat16).float()
                p = hi + (p - hi).to(torch.bfloat16).float()
            acc = alpha * acc + torch.matmul(p, vb)
            m = m_new
        den = torch.clamp(l, min=1e-30)
        o = acc / den
        out[:, :, q0:q0 + n] = o.reshape(B, H, n, d).to(q.dtype)
        row_lse = (m + torch.log2(den)) * LN2 if split_p else m + torch.log(den)
        lse[:, :, q0:q0 + n] = row_lse.reshape(B, H, n)
    return (out, lse) if return_lse else out


#: q rows of a dQ CTA and KV rows of a dK/dV CTA in the backward's wgmma
#: kernels (two consumer warpgroups of 64), and the rows the scratch of D
#: and the log-sum-exp pads each head to
BWD_ROWS = 2 * CONSUMER_ROWS


def bwd_block_shape(d: int, dtype: torch.dtype) -> tuple[int, int]:
    """(q rows, KV rows) of a block of the backward's dQ pass, and so of
    the plain backward's loop (it decides only the order of the plain
    version's sums): bf16 (the wgmma kernels) 128 q rows (two consumer
    warpgroups of 64) against KV tiles of 128 rows, 64 at d = 128 and 32
    at d = 256 (registers); f32 (the CUDA-core forms) 64 x 64.  The wgmma
    dK/dV pass takes q blocks of 64 rows against 128 KV rows a CTA, or 64
    in its cluster-pair form (where 128-row CTAs would leave SMs idle); at
    d = 256 against 64 KV rows a cluster of 2 or 4 CTAs, each consumer
    half the head dim; the CUDA-core one 64 x 64."""
    if dtype == torch.bfloat16:
        return BWD_ROWS, {128: 64, 256: 32}.get(d, 128)
    return 64, 64


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              prefix_len: int | None = None,
                              block_q: int | None = None,
                              block_k: int | None = None):
    """Plain PyTorch version of the backward kernels, with their
    arithmetic: ``D = rowsum(dO ∘ O)`` in f32; per q block of the dQ pass
    (``bwd_block_shape`` unless given) over the KV tiles of `_kv_range`, P
    recomputed from the log-sum-exp (bf16: 2^(s d^-0.5 log2(e) - lse
    log2(e)), the forward's log2 units; f32: e^(s d^-0.5 - lse)), 0 where
    the mask forbids, ``dP = dO Vᵀ``, ``dS = P ∘ (dP - D)``, ``dV += Pᵀ dO``,
    ``dK += dSᵀ Q`` and ``dQ += dS K``, with P and dS rounded to bf16 once,
    as the tensor cores take them, for bf16 inputs; dQ and dK times d^-0.5
    at the end.  The G query heads of a KV head add into its dK and dV.
    The block shape changes only the order of the f32 sums.  Returns (dq,
    dk, dv) in q's dtype, accumulated in f32."""
    B, H, Sq, d = q.shape
    bq, bk = bwd_block_shape(d, q.dtype)
    block_q, block_k = block_q or bq, block_k or bk
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    pre = _prefix(causal, prefix_len)
    bf16 = q.dtype == torch.bfloat16
    scale = _scale(d, q.dtype)
    scale_nat = _scale(d)
    exp = torch.exp2 if bf16 else torch.exp
    rnd = _bf16_round if bf16 else (lambda x: x)
    lse_u = lse.float() * LOG2E if bf16 else lse.float()
    dev = q.device
    pad_k = -(-Sk // block_k) * block_k
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad_k - Sk))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad_k - Sk))
    dk = torch.zeros((B, K, pad_k, d), device=dev)
    dv = torch.zeros((B, K, pad_k, d), device=dev)
    dq = torch.empty((B, H, Sq, d), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, block_q):
        n = min(block_q, Sq - q0)
        # [B, K, G * n, d]: head h = kh * G + g, row index g * n + i
        def rows_of(x):
            return x[:, :, q0:q0 + n].float().reshape(B, K, G * n, -1)
        qb, dob, ob = rows_of(q), rows_of(do), rows_of(o)
        delta = (dob * ob).sum(dim=-1, keepdim=True)
        lb = lse_u[:, :, q0:q0 + n].reshape(B, K, G * n, 1)
        rows = (q0 + torch.arange(n, device=dev)).repeat(G)[:, None]
        dq_acc = torch.zeros((B, K, G * n, d), device=dev)
        lo, hi = _kv_range(q0, Sk, causal, window, block_q, block_k, pre)
        for k0 in range(lo, hi, block_k):
            kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            cols = k0 + torch.arange(block_k, device=dev)[None, :]
            p = torch.where(_allowed(rows, cols, Sk, causal, window, pre),
                            exp(s - lb), 0.0)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = rnd(p * (dp - delta))
            dv[:, :, k0:k0 + block_k] += torch.matmul(rnd(p).transpose(-1, -2),
                                                      dob)
            dk[:, :, k0:k0 + block_k] += torch.matmul(ds.transpose(-1, -2), qb)
            dq_acc += torch.matmul(ds, kb)
        dq[:, :, q0:q0 + n] = (dq_acc * scale_nat).reshape(
            B, H, n, d).to(q.dtype)
    return (dq, (dk[:, :, :Sk] * scale_nat).to(q.dtype),
            dv[:, :, :Sk].to(q.dtype))


# ---------------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------------

def _checked(q, k, v, window, prefix_len=None) -> bool:
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
    if prefix_len is not None and prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0 or None, got {prefix_len}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type == "cuda"


def check_kernel_inputs(q, k, v) -> list[tuple[int, ...]]:
    """What the kernel takes beyond `_checked`: a head dimension it is
    instantiated for, tensors TMA can read (``tensor_map``), B * H within
    the grid.  Returns the tensor-map rows of q, k and v."""
    B, H, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dimension {d} has no kernel; supported: "
                         f"{HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's y limit")
    block_q, block_k = block_shape(d, q.dtype)
    rows = []
    for name, x, box_rows in (("q", q, block_q), ("k", k, block_k),
                              ("v", v, block_k)):
        try:
            rows.append(tensor_map(x, box_rows))
        except ValueError as exc:
            raise ValueError(f"{name}: {exc}") from None
    return rows


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/flash_attention.cu`` (or from a variant of it)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [ci] * 7 + [ctypes.POINTER(ctypes.c_longlong), ci, ci,
                               ci, ctypes.c_float, vp, vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


def _launch(q, k, v, causal, window, prefix_len, with_lse: bool):
    """One launch of the forward kernel on CUDA tensors: (out, lse), lse
    None unless ``with_lse``."""
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    # rows lie below Sq and keys below Sk: a longer prefix means no more
    pre = min(_prefix(causal, prefix_len), max(Sq, Sk))
    out = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    maps = check_kernel_inputs(q, k, v)
    maps.append(tensor_map(out, CONSUMER_ROWS))
    table = (ctypes.c_longlong * (4 * len(MAP_FIELDS)))(
        *[n for row in maps for n in row])
    lib = _lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, K, Sq, Sk, d, table,
            int(causal), int(window or 0), pre, _scale(d, q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream,
            None if lse is None else lse.data_ptr())
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {code} "
                           f"({msg})")
    flash_attention.launches += 1
    flash_attention.bidirectional_launches += int(not causal)
    flash_attention.prefix_launches += int(pre > 0)
    flash_attention.lse_launches += int(with_lse)
    return out, lse


class FlashAttention(torch.autograd.Function):
    """K4 under autograd: the forward kernel with its log-sum-exp output
    (the plain version for CPU tensors), saving q, k, v, the output and the
    log-sum-exp; the backward is `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix_len):
        if q.device.type == "cuda":
            out, lse = _launch(q, k, v, causal, window, prefix_len, True)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window,
                                             prefix_len=prefix_len,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, prefix_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, prefix_len = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, window=window,
                                         prefix_len=prefix_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int | None = None) -> torch.Tensor:
    """softmax(mask(q kᵀ d^-0.5)) v per head, [B, H, Sq, d] in q's dtype.
    Counterpart of ``repro.kernels.flash_attention.flash_attention``, and
    with ``prefix_len`` P of the reference's prefix-LM mask (causal, plus
    rows below P attending to every key below P; ignored unless causal).

    The kernel takes head dimensions 16, 32, 64, 128 and 256 (every
    config's at full width: recurrentgemma-9b's local attention and
    paligemma-3b's attention are at 256); CPU tensors of any head
    dimension go to the plain version.  Where grad mode is on and an input
    requires grad it runs as `FlashAttention`, differentiable."""
    on_cuda = _checked(q, k, v, window, prefix_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, prefix_len)
    if not on_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     prefix_len=prefix_len)
    return _launch(q, k, v, causal, window, prefix_len, False)[0]


flash_attention.launches = 0
flash_attention.bidirectional_launches = 0
flash_attention.prefix_launches = 0
flash_attention.lse_launches = 0


# ---------------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------------

def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``csrc/flash_attention_bwd.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    llp = ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_bwd_launch.argtypes = (
        [vp] * 10 + [ci] * 7 + [llp, llp, ci, ci, ci, ctypes.c_float, vp])
    lib.flash_attention_bwd_launch.restype = ci
    lib.flash_attention_bwd_error_string.argtypes = [ci]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_lib() -> ctypes.CDLL:
    return bind_bwd(_build.load("flash_attention_bwd"))


#: the backward launcher's code for a refused tensor map (less its row)
_MAP_REFUSED = -100


def _vector_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the backward kernels can read its rows with
    16-byte loads (last dimension contiguous, base and the other strides
    multiples of 16 bytes), else a contiguous copy."""
    es = x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(i) * es % 16 == 0 or x.shape[i] == 1
                    for i in range(3))):
        return x
    return x.contiguous()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        prefix_len: int | None = None):
    """The gradients (dq, dk, dv) of `flash_attention`'s output ``o`` with
    cotangent ``do``, given each row's log-sum-exp ``lse`` from the forward:
    for CUDA tensors two launches of ``csrc/flash_attention_bwd.cu`` (dQ
    with D = rowsum(dO ∘ O), then dK and dV, each KV tile summing its G
    query heads in one CTA or, on small grids, in a cluster whose partial
    sums meet in a fixed order; no atomics), counted once in
    ``flash_attention_bwd.launches``; for CPU tensors
    `flash_attention_bwd_plain`.  The gradients come out in q's dtype."""
    mask = {"causal": causal, "window": window, "prefix_len": prefix_len}
    if not _checked(q, k, v, window, prefix_len):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **mask)
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dimension {d} has no kernel; supported: "
                         f"{HEAD_DIMS}")
    if do.shape != q.shape or o.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    pre = min(_prefix(causal, prefix_len), max(Sq, Sk))
    ins = [_vector_ready(x.to(q.dtype)) for x in (q, k, v, o, do)]
    lse = lse.float().contiguous()
    dq = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, K, Sk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # D and, for the wgmma kernels, the rows' log-sum-exp in log2 units,
    # each head's rows padded to BWD_ROWS
    pad = -(-Sq // BWD_ROWS) * BWD_ROWS
    dsum = torch.empty(2 * B * H * pad, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *[x.stride(i) for x in ins for i in range(3)])
    maps = (ctypes.c_longlong * (8 * len(MAP_FIELDS)))(
        *[n for x in (*ins, dq, dk, dv)
          for n in tensor_map(x, CONSUMER_ROWS)])
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        code = lib.flash_attention_bwd_launch(
            *[x.data_ptr() for x in ins], lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, K, Sq, Sk, d, strides, maps,
            int(causal), int(window or 0), pre, _scale(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if _MAP_REFUSED - 8 < code <= _MAP_REFUSED:
        names = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
        raise RuntimeError(f"flash_attention_bwd: the kernels or the driver "
                           f"refused the tensor map of "
                           f"{names[_MAP_REFUSED - code]}")
    if code != 0:
        msg = lib.flash_attention_bwd_error_string(code).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{code} ({msg})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
