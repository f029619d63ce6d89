"""The shortlist's prescreen: an admissible Eq. 2 bound per row and its top K.

The two-stage shortlist of the fused engine sweeps every victim subset of
only K rows.  Its first stage bounds each resident row's best score from
the row's aggregates alone (no subset axis) and keeps the K rows with the
highest bounds, one representative row per equivalence class; the best
bound left out is the certainty reference of the second stage.

====================  ==========================  ========================
wrapper               plain version               replaces (repro)
====================  ==========================  ========================
``prescreen``         ``prescreen_plain``         ``core/preemption_jax.py
                      (``prescreen_core``)        :839 _prescreen_core``
                                                  (an XLA program)
``prescreen_select``  ``prescreen_select_plain``  the cross-shard
                                                  ``lax.top_k`` of the
                                                  sharded prescreen
====================  ==========================  ========================

The bound of a row is ``max(ub0, ubk)``: ``ub0`` the exact score of the
empty subset (the tier of the free masks, priority term 1) and ``ubk`` the
tier of the free masks with every eligible victim freed (any subset frees
less, and the tier is monotone in what is freed) with the priority term of
the least eligible priority (any subset's sum is at least that), both in
the f32 arithmetic of Eq. 1.  A row enters when it is its class's
representative (``rep``, or one of the ``forced`` rows), has at most
`NARROW_M` eligible victims, is not truncated below the preemptor, has a
real node id and a finite bound.  The K entering rows with the largest
``(bound, -row)`` form ``gidx`` (``lax.top_k`` breaks ties toward the lower
row, which ``torch.topk`` does not promise, so both forms order an explicit
key), padded with `IDX_SENTINEL`; ``excl_ub`` is the bound of the (K+1)-th,
or -inf.

The prescreen is one launch of ``prescreen_cluster_kernel`` in
``csrc/topo_score.cu``: a thread-block cluster (`max_cluster_ctas` CTAs;
several clusters at many rows, `prescreen_geometry`), each CTA a segment of
rows, 16 lanes a row (one a slot), the bound from the shared tier rule
(``numa_words`` + ``fused_tier``) as a 64-bit key ``(ordered bound,
inverted row)`` kept in shared memory; each CTA ranks its live keys by
counting (after an exact radix select where they are many) and sends its
top K in order to the cluster's first CTA through distributed shared
memory (each CTA a copy), which ranks its own keys among them by counting.
The union select over a sharded state is ``prescreen_union_kernel``, the
same device code in one CTA.  The output is int32[K + 1]: ``gidx`` and the bits of ``excl_ub``.

The wrapper runs the plain version for tensors on the CPU and launches the
kernels for tensors on a CUDA device; anything else raises.  It counts its
launches in ``prescreen.launches`` (one a call).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.cluster import (IDX_SENTINEL, NS_FREE_CG, NS_FREE_GPU,
                                      NS_NEXT_PRIO, NS_NODE_ID, NS_OVERFLOW,
                                      VF_CG, VF_GPU, VF_PRIO, VF_STORED,
                                      apply_rows)
from repro_torch.core.placement_device import best_tier_counts, spec_slices
from repro_torch.core.scoring import TIER_SCORES
from repro_torch.core.topology import ServerSpec

from . import topo_score as ts
from .fused_class import (FusedRequest, launch_state, lib,
                          max_cluster_ctas, on_cuda, params, stream_of,
                          ticket)

#: the most eligible victims a row may hold to enter the shortlist (the
#: second stage sweeps it at this width)
NARROW_M = 8
_INT32_MAX = 2**31 - 1
#: the prescreen's global scratch, by (device, stream): the launches of one
#: stream use it one after the other
_SCRATCH: dict = {}


def prescreen_core(nodestate, victims, rep, *, req: FusedRequest,
                   spec: ServerSpec, k: int):
    """The reference's ``_prescreen_core`` in PyTorch over rows
    ``(nodestate, victims)`` and the representative mask ``rep`` (bool[N]):
    ``(gidx int32[k], excl_ub f32[])``, the top K by an explicit stable
    sort."""
    ub, ok = _bounds(nodestate, victims, rep, req=req, spec=spec)
    neg = torch.tensor(-np.inf, dtype=torch.float32, device=ub.device)
    ubm = torch.where(ok, ub, neg)
    topv, topi = torch.sort(ubm, descending=True, stable=True)
    topv, topi = topv[:k], topi[:k]
    live = topv > neg
    gidx = torch.where(live, topi, _INT32_MAX).to(torch.int32)
    selm = torch.zeros(ubm.shape[0], dtype=torch.bool, device=ub.device)
    selm[topi[live]] = True
    excl_ub = torch.where(ok & ~selm, ub, neg).max()
    return gidx, excl_ub


def _bounds(nodestate, victims, rep, *, req: FusedRequest, spec: ServerSpec):
    """Each row's admissible bound ``ub`` (f32[N]) and whether it enters
    (``ok``, bool[N])."""
    dev = nodestate.device
    f32 = dict(dtype=torch.float32, device=dev)
    sl = spec_slices(spec, dev)
    thresh, ng, nc, cpb = (req.thresh, req.need_gpus, req.need_cgs,
                           req.cgs_per_bundle)
    free_gpu, free_cg = nodestate[NS_FREE_GPU], nodestate[NS_FREE_CG]
    stored = victims[VF_STORED] != 0
    vp = victims[VF_PRIO]
    elig = stored & (vp < thresh)
    elig_n = elig.sum(dim=1)
    # victim masks are disjoint and disjoint from free: freeing the whole
    # eligible prefix is a sum (int32, wrapping as the reference's)
    eg, ec = free_gpu.clone(), free_cg.clone()
    for j in range(victims.shape[2]):
        eg += torch.where(elig[:, j], victims[VF_GPU, :, j], 0)
        ec += torch.where(elig[:, j], victims[VF_CG, :, j], 0)
    et, _, _ = best_tier_counts(eg, ec, ng, nc, cpb, sl)
    ft, _, _ = best_tier_counts(free_gpu, free_cg, ng, nc, cpb, sl)
    tier_vals = torch.tensor(tuple(TIER_SCORES) + (0.0,), **f32)
    min_p = torch.where(elig, vp, _INT32_MAX).amin(dim=1)
    one = torch.ones(min_p.shape, **f32)
    pterm = torch.where(min_p > 0, torch.div(
        one, torch.clamp(min_p, min=1).to(torch.float32)), one)
    a = torch.tensor(np.float32(req.alpha), **f32)
    b = torch.tensor(np.float32(1.0 - req.alpha), **f32)
    neg = torch.tensor(-np.inf, **f32)
    ft64, et64 = ft.to(torch.int64), et.to(torch.int64)
    ub0 = torch.where(ft < 3, a * one + b * tier_vals[ft64], neg)
    ubk = torch.where((elig_n > 0) & (et < 3), a * pterm + b * tier_vals[et64],
                      neg)
    ub = torch.maximum(ub0, ubk)
    ok = ((nodestate[NS_NODE_ID] < _INT32_MAX) & rep & (elig_n <= NARROW_M)
          & ~((nodestate[NS_OVERFLOW] != 0)
              & (nodestate[NS_NEXT_PRIO] < thresh)) & (ub > neg))
    return ub, ok


def _rows(nodestate, victims, pidx, pbuf, rep, forced, base: int):
    """The resident rows with the patch rows written over them and the
    forced rows set in the representative mask (global row ids for a
    shard whose first row is ``base``)."""
    if pbuf.shape[0]:
        drain = torch.zeros((2, nodestate.shape[1]), dtype=torch.int32,
                            device=nodestate.device)
        nodestate, victims, _ = apply_rows(
            nodestate, victims, drain, pidx.to(torch.int64) - base, pbuf)
    rep = rep != 0
    if forced.shape[0]:
        f = forced.to(torch.int64) - base
        rep = rep.clone()
        rep[f[(f >= 0) & (f < rep.shape[0])]] = True
    return nodestate, victims, rep


def keys_of(ub: torch.Tensor, rows) -> np.ndarray:
    """The kernels' 64-bit keys ``(ordered bound) << 32 | ~row`` of bounds
    ``ub`` at global rows ``rows``, as uint64."""
    i = (ub.cpu() + 0.0).numpy().astype(np.float32).view(np.int32)
    ordered = i ^ ((i >> 31) & 0x7FFFFFFF)
    hi = (ordered.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    lo = (np.uint64(0xFFFFFFFF)
          - np.asarray(rows, np.int64).astype(np.uint64))
    return (hi << np.uint64(32)) | lo


def bound_of(keys: np.ndarray) -> np.ndarray:
    """The f32 bounds of uint64 keys (`keys_of`'s inverse on the bound)."""
    u = ((keys >> np.uint64(32)).astype(np.uint32)
         ^ np.uint32(0x80000000)).view(np.int32)
    return (u ^ ((u >> 31) & 0x7FFFFFFF)).view(np.float32)


def prescreen_plain(nodestate, victims, pidx, pbuf, rep, forced, *, k: int,
                    req: FusedRequest, spec: ServerSpec,
                    base: int = 0) -> torch.Tensor:
    """Plain version of `prescreen`: `prescreen_core` over the resident
    rows with the patch rows written over them and the forced rows set in
    the representative mask; int32[k + 1]."""
    nodestate, victims, rep = _rows(nodestate, victims, pidx, pbuf, rep,
                                    forced, base)
    gidx, excl_ub = prescreen_core(nodestate, victims, rep, req=req,
                                   spec=spec, k=k)
    gidx = torch.where(gidx < _INT32_MAX, gidx + base, gidx)
    return torch.cat([gidx, excl_ub.reshape(1).view(torch.int32)])


def prescreen_sel_plain(nodestate, victims, pidx, pbuf, rep, forced, *,
                        k: int, req: FusedRequest, spec: ServerSpec,
                        base: int = 0) -> torch.Tensor:
    """The keys `prescreen` selects into ``sel``: int64[k], the top K keys
    (`keys_of`) in descending order as bit patterns, then 0 (the kernel
    leaves the selected ones in any order)."""
    nodestate, victims, rep = _rows(nodestate, victims, pidx, pbuf, rep,
                                    forced, base)
    ub, ok = _bounds(nodestate, victims, rep, req=req, spec=spec)
    rows = ok.cpu().nonzero()[:, 0].numpy()
    keys = np.sort(keys_of(ub[rows.tolist()], rows + base))[::-1][:k]
    out = np.zeros(k, np.uint64)
    out[:len(keys)] = keys
    return torch.from_numpy(out.view(np.int64).copy()).to(nodestate.device)


def prescreen(nodestate, victims, pidx, pbuf, rep, forced, *, k: int,
              req: FusedRequest, spec: ServerSpec,
              skip: torch.Tensor | None = None,
              out: torch.Tensor | None = None, base: int = 0,
              sel: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 1 of the shortlist over every resident row (patch rows read in
    place of theirs, ``rep`` int32[N] the class representatives, ``forced``
    int32[F] ascending rows taken as representatives too): int32[k + 1],
    the top-K rows ``gidx`` (`IDX_SENTINEL` past the entering rows) and the
    bits of ``excl_ub``, written into ``out`` when given.  With ``skip``
    set it does nothing and its output is undefined.  Any ``1 <= k <=
    N``.  Counterpart of ``_prescreen_core`` behind the overlay.

    For a shard of a sharded state (first row global row ``base``;
    ``pidx``, ``forced`` and the output rows global), ``sel`` (int64[k])
    receives the selected keys, 0 past them, for the union select
    (`prescreen_select`)."""
    n = nodestate.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"prescreen: k={k} outside 1..{n}")
    if rep.shape != (n,) or forced.dim() != 1:
        raise ValueError(f"prescreen: rep {tuple(rep.shape)} and forced "
                         f"{tuple(forced.shape)} for {n} rows")
    if out is not None and (out.numel() != k + 1 or out.dtype != torch.int32
                            or not out.is_contiguous()):
        raise ValueError(f"out must hold {k + 1} int32")
    if not on_cuda(nodestate, victims, pidx, pbuf, rep, forced):
        if skip is not None and int(skip.reshape(-1)[0]):
            if out is not None:         # as the kernel: nothing written
                return out
            got = torch.full((k + 1,), IDX_SENTINEL, dtype=torch.int32)
        else:
            got = prescreen_plain(nodestate, victims, pidx, pbuf, rep,
                                  forced, k=k, req=req, spec=spec, base=base)
            if sel is not None:
                sel.copy_(prescreen_sel_plain(
                    nodestate, victims, pidx, pbuf, rep, forced, k=k,
                    req=req, spec=spec, base=base))
        if out is None:
            return got
        out.copy_(got)
        return out
    st = launch_state(nodestate, victims, None, pidx, pbuf, None,
                      resident=True, base=base)
    if sel is not None and (sel.numel() != k or sel.dtype != torch.int64
                            or not sel.is_contiguous()
                            or sel.device != nodestate.device):
        raise ValueError(f"sel must hold {k} int64 beside the state")
    for name, x in (("rep", rep), ("forced", forced)):
        if (x.dtype != torch.int32 or not x.is_contiguous()
                or x.device != nodestate.device):
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             "beside the state")
    dev = nodestate.device
    if out is None:
        out = torch.empty(k + 1, dtype=torch.int32, device=dev)
    ctas, clusters, words, _ = prescreen_geometry(n, k, st.device)
    stream = stream_of(st)
    scratch = _scratch(dev, stream, words) if words else None
    lb = lib()
    code = lb.prescreen_launch(
        ctypes.byref(st), ctypes.byref(params(spec, req)), rep.data_ptr(),
        forced.data_ptr() if forced.shape[0] else None, forced.shape[0], k,
        ctas, clusters, None if skip is None else skip.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        ticket(dev, stream).data_ptr() if clusters > 1 else None,
        None if sel is None else sel.data_ptr(), out.data_ptr(), st.device,
        stream)
    ts._raise_on(lb, code, "prescreen")
    prescreen.launches += 1
    return out


prescreen.launches = 0


@functools.lru_cache(maxsize=256)
def prescreen_geometry(n: int, k: int, device: int) -> tuple[int, int, int,
                                                             int]:
    """The prescreen's launch over ``n`` rows, top ``k``, on CUDA device
    ``device``, as its launcher rules it: ``(ctas, clusters, words, form)``,
    clusters of `max_cluster_ctas` CTAs (one, or the split form's several
    where the rows are many: C ``prescreen_clusters``), the 64-bit words of
    global scratch the launch takes (0 at the main path's shapes) and the
    kernel instance (bit 0: the keys in global scratch; bit 1: the CTAs'
    lists; C ``prescreen_scratch_words``)."""
    ctas = max_cluster_ctas(device)
    lb = lib()
    clusters = lb.prescreen_clusters(n, k, ctas,
                                     resident_clusters(device, ctas))
    form = ctypes.c_int(0)
    words = lb.prescreen_scratch_words(n, k, ctas, clusters,
                                       ctypes.byref(form))
    return ctas, clusters, words, form.value


@functools.lru_cache(maxsize=None)
def resident_clusters(device: int, ctas: int) -> int:
    """The most clusters of ``ctas`` CTAs of the prescreen CUDA device
    ``device`` keeps resident at once."""
    return lib().prescreen_max_clusters(device, ctas)


def _scratch(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    """At least ``words`` int64 of the prescreen's global scratch for the
    launches of ``stream`` on ``dev``, kept from call to call."""
    t = _SCRATCH.get((dev, stream))
    if t is None or t.numel() < words:
        t = _SCRATCH[dev, stream] = torch.empty(words, dtype=torch.int64,
                                                device=dev)
    return t


def prescreen_select_plain(keys: torch.Tensor, k: int,
                           excl: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `prescreen_select`: the top ``k`` of the nonzero
    keys (int64 bit patterns of uint64) as rows, then the bits of the
    larger of the (k+1)-th key's bound and each of ``excl`` (int32 bits
    of f32)."""
    u = keys.cpu().numpy().view(np.uint64).reshape(-1)
    u = np.sort(u[u != 0])[::-1]
    out = np.full(k + 1, IDX_SENTINEL, np.int64)
    top = u[:k]
    out[:len(top)] = (np.uint64(0xFFFFFFFF)
                      - (top & np.uint64(0xFFFFFFFF))).astype(np.int64)
    ub = np.float32(bound_of(u[k:k + 1])[0]) if len(u) > k \
        else np.float32(-np.inf)
    if excl is not None:
        for e in excl.cpu().numpy().astype(np.int32).view(np.float32):
            ub = max(ub, e)
    out[k] = int(np.float32(ub).view(np.int32))
    return torch.from_numpy(out.astype(np.int32)).to(keys.device)


def prescreen_select(keys: torch.Tensor, *, k: int,
                     excl: torch.Tensor | None = None,
                     skip: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The prescreen's select alone (``prescreen_union_kernel``, one CTA)
    over given keys: the top ``k`` of ``keys`` (int64, `keys_of`' bit
    patterns, 0 for no row) as int32[k + 1], the rows (`IDX_SENTINEL`
    past the entries) and the bits of ``excl_ub``, raised to each of
    ``excl`` (int32 f32 bits, a strided view allowed) when given.  With
    ``skip`` set it does nothing.  Written into ``out`` when given.

    Over a sharded state ``keys`` holds every shard's selected keys
    (`prescreen` with ``sel=``) and ``excl`` every shard's ``excl_ub``:
    the result is what `prescreen` gives over the unsharded rows (the
    shortlist's union select, in place of the reference's cross-shard
    ``lax.top_k``).  It counts its launches in
    ``prescreen_select.launches``."""
    flat = keys.reshape(-1)
    if excl is not None and excl.dim() != 1:
        raise ValueError("excl must be one-dimensional")
    extra = [] if excl is None else [excl]
    if not on_cuda(flat, *extra, *([] if skip is None else [skip])):
        if skip is not None and int(skip.reshape(-1)[0]):
            if out is not None:         # as the kernel: nothing written
                return out
            got = torch.full((k + 1,), IDX_SENTINEL, dtype=torch.int32)
        else:
            got = prescreen_select_plain(flat, k, excl)
        if out is None:
            return got
        out.copy_(got)
        return out
    dev = flat.device
    if out is None:
        out = torch.empty(k + 1, dtype=torch.int32, device=dev)
    if (flat.dtype != torch.int64 or not flat.is_contiguous()
            or out.numel() != k + 1 or out.dtype != torch.int32
            or not out.is_contiguous() or out.device != dev
            or any(x.device != dev or x.dtype != torch.int32
                   for x in extra)):
        raise ValueError(f"keys (int64), excl and out ({k + 1} int32) must "
                         "lie on one device")
    n = flat.numel()
    lists = keys.shape[0] if keys.dim() == 2 else 1
    lb = lib()
    words = lb.prescreen_union_words(n, k, lists)
    scratch = (torch.empty(words, dtype=torch.int64, device=dev)
               if words else None)
    code = lb.prescreen_select_launch(
        flat.data_ptr(), n, k, lists,
        None if excl is None else excl.data_ptr(),
        0 if excl is None else excl.shape[0],
        1 if excl is None else excl.stride(0),
        None if skip is None else skip.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    ts._raise_on(lb, code, "prescreen_select")
    prescreen_select.launches += 1
    return out


prescreen_select.launches = 0

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (prescreen, prescreen_select)

__all__ = ["NARROW_M", "WRAPPERS", "bound_of", "keys_of", "prescreen",
           "prescreen_core", "prescreen_geometry", "prescreen_plain",
           "prescreen_sel_plain", "prescreen_select",
           "prescreen_select_plain", "resident_clusters"]
