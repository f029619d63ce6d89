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
and ``flash_attention.prefix_launches``.

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

import numpy as np
import torch

from . import _build

#: masked score: finite, as in the reference (a fully masked tile must not
#: give exp(-inf + inf))
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
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
    B, heads, S, d = x.shape
    es = x.element_size()
    if x.stride(3) != 1:
        raise ValueError("the last dimension must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("the base address must be 16-byte aligned")
    if not all(0 < n < 2 ** 32 for n in x.shape):
        raise ValueError(f"dims {tuple(x.shape)} must lie in [1, 2^32)")
    strides = []
    for dim in (2, 1, 0):
        nbytes = x.stride(dim) * es if x.shape[dim] > 1 else 16
        if nbytes % 16 or not 0 < nbytes < 2 ** 40:
            raise ValueError(f"byte stride {nbytes} of dim {dim} must be a "
                             "positive multiple of 16 below 2^40")
        strides.append(nbytes)
    box = (0, 0, 0)
    if x.dtype == torch.bfloat16:
        span = min(d, 64)
        box = (span, box_rows, 2 * span)
    return (d, S, heads, B, *strides, *box)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          prefix_len: int | None = None,
                          block_q: int | None = None,
                          block_k: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its arithmetic: the same
    blocked loop and bounds (``block_shape`` unless given), the finite
    sentinel, the f32 online softmax, for bf16 inputs the softmax in log2
    units (2^(s log2(e) - m log2(e)) = e^(s - m)) and P carried as bf16
    hi + lo parts (a 16-bit mantissa) in P V, and ``acc / max(l, 1e-30)``
    cast to q's dtype.  ``prefix_len`` P (causal only): rows below P also
    attend to every key below P."""
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
            mask = (cols <= rows) if causal else (cols >= 0)
            if window:
                mask = mask & ((rows - cols) < window)
            if pre:
                mask = mask | ((rows < pre) & (cols < pre))
            s = torch.where(mask & (cols < Sk), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = exp(s - m_new)
            alpha = exp(m - m_new)
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
                               ci, ctypes.c_float, vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("flash_attention"))


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
    dimension go to the plain version."""
    if not _checked(q, k, v, window, prefix_len):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     prefix_len=prefix_len)
    B, H, Sq, d = q.shape
    K, Sk = k.shape[1], k.shape[2]
    # rows lie below Sq and keys below Sk: a longer prefix means no more
    pre = min(_prefix(causal, prefix_len), max(Sq, Sk))
    out = torch.empty((B, H, Sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
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
            torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {code} "
                           f"({msg})")
    flash_attention.launches += 1
    flash_attention.bidirectional_launches += int(not causal)
    flash_attention.prefix_launches += int(pre > 0)
    return out


flash_attention.launches = 0
flash_attention.bidirectional_launches = 0
flash_attention.prefix_launches = 0
