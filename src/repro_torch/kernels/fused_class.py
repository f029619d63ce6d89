"""K1 in its resident form: the fused engine's class sweep and its tail.

One plan of the ``imp_batched`` engine scores every victim subset of every
row of the device-resident cluster state in ONE launch, then reduces the
class winners to the Eq. 2 winner and places it in a second.  Two
hand-written CUDA kernels in ``csrc/topo_score.cu`` (beside the lane forms
of K1–K3, whose tier math they share), each with its plain PyTorch version
in this module:

=================  =====================  ====================================
wrapper            plain version          replaces (repro)
=================  =====================  ====================================
``fused_class``    ``fused_class_plain``  ``core/preemption_jax.py
                                          _fused_class_core``, the sweep K1
                                          (``kernels/topo_score.py:214
                                          topo_score_argmax_pallas``) scores
                                          lane by lane
``fused_argmax``   ``fused_argmax_plain`` ``_fused_argmax_core`` +
                                          ``placement_jax.winner_place``
=================  =====================  ====================================

A plan's rows are the resident rows (with the plan's patch rows read in
their place) at the adaptive width ``m_res`` behind the narrow gate, then
the rows gathered by index (``gidx``) at ``m_gather`` without it.  The
sweep's output ``cls`` is int32[`CLS_FIELDS`, rows]: per row the (row,
tier) class winners (any, combo id, priority sum, uid-rank mask for each
of the three tiers), the smallest feasible subset size, the count of
feasible subsets at that size, and the node id.  The tail reduces each
segment of ``seg`` rows to one int32[`WIN_FIELDS`] winner, in one pass
over the rows by one thread-block cluster a segment (`cluster_geometry`),
the CTAs merging through distributed shared memory.  The sweep gives each
row a group of threads chosen from its section's width and the plan's rows
(`sweep_geometry`): 16 or 32 threads up to 8 slots, a CTA of
`WIDE_THREADS` above.

A wrapper runs the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; anything else raises.  Each wrapper
counts its launches in ``<wrapper>.launches``.  ``skip`` (an int32 tensor
of one element, the normal cycle's ``found``) makes both return at once
when it is set: the kernels read it on the device, so a plan chains the
normal cycle, the sweep and the tail without a host round trip.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.cluster import (IDX_SENTINEL, MAX_DENSE_VICTIMS,
                                      NS_FREE_CG, NS_FREE_GPU, NS_NEXT_PRIO,
                                      NS_NODE_ID, NS_OVERFLOW, VF_CG, VF_GPU,
                                      VF_PRIO, VF_RANK, VF_STORED, apply_rows)
from repro_torch.core.placement_device import (best_tier_counts, place_core,
                                               popcount32, spec_slices)
from repro_torch.core.scoring import TIER_SCORES
from repro_torch.core.topology import ServerSpec

from . import topo_score as ts

#: rows of the sweep's output: anyc[3], combo id[3], priority sum[3],
#: uid-rank mask[3], smallest feasible k, its count, node id
CLS_FIELDS = 15
C_ANY, C_CB, C_PP, C_UM, C_K, C_CNT, C_NID = 0, 3, 6, 9, 12, 13, 14
#: width of one decoded winner: (found, row, tier, combo id, priority sum,
#: k, n_candidates) + the placement's (gpu_mask, cg_mask)
WIN_FIELDS = 9
#: widest slot count of the narrow sweep (a group of at most a warp a row);
#: wider rows take the one-CTA-a-row kernel
NARROW_KERNEL_M = 8
#: the most threads a CTA of the narrow sweep takes, and the threads of the
#: wide sweep's CTA (kNarrowThreads, kWideThreads in csrc/topo_score.cu)
SWEEP_THREADS = 256
WIDE_THREADS = 512
#: CTAs of the narrow sweep an SM should find in the first wave
SWEEP_CTAS_PER_SM = 2
#: threads a row where two rows share a warp (a large plan's narrow sweep):
#: where both have at most 4 eligible slots (one subset a thread) each group
#: sweeps its own row, else the warp sweeps them one after the other; the
#: group's last two lanes fold the row's free and drained masks
SHARED_GROUP = 16
#: rows a SM up to which the narrow sweep gives each row a warp (on an H100
#: a warp a row is faster at 1024 saturated rows, two rows a warp at 10240:
#: PERF.md)
SWEEP_WARP_ROWS = 16
_INT32_MAX = 2**31 - 1
_MAX_SCOPES = 8 + 8 + 1     # FusedParams.scope_* widths in csrc/topo_score.cu
#: CTAs of the portable thread-block cluster (kClusterCtas), and the most
#: threads a CTA of K2's normal-cycle form and of K1's tail take
#: (kNormalThreads, kTailThreads in csrc/topo_score.cu)
CLUSTER_CTAS = 8
NORMAL_THREADS = 1024
TAIL_THREADS = 512
#: rows a CTA takes before the cluster grows by another CTA: the per-row
#: work of K2 (the node's tier) and of the tail (three Eq. 1 scores) is
#: spread over SMs, against one more CTA at the cluster barrier
CTA_ROWS = 128
#: the most patch rows a launch takes: K2 and the tail stage the patch
#: index in shared memory (kMaxPatchRows, 64 KB)
MAX_PATCH_ROWS = 16384
#: width of a shard's tail record (kPartFields in csrc/topo_score.cu): the
#: tail's monoid state (score bits, tmin, tmax, count, two tie keys of 5),
#: the two keys' entries placed (combo id, priority sum, gpu and cg masks
#: each), and the segment's first row (held here, combo id, priority sum,
#: k, gpu and cg masks)
PART_FIELDS = 28


@dataclasses.dataclass(frozen=True)
class FusedRequest:
    """A preemptor's ask as the fused kernels take it."""

    thresh: int           # preemptor priority: victims must be below it
    need_gpus: int
    need_cgs: int
    cgs_per_bundle: int   # 0 = no bundle locality
    alpha: float          # Eq. 1 weight


# ---------------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------------

def plan_rows(nodestate, victims, drain, pidx, pbuf, gidx, resident: bool,
              base: int = 0):
    """The plan's rows as ``(nodestate, victims, drain)`` column stacks:
    the resident rows with the patch rows written over them (when
    ``resident``), then the rows named by ``gidx``; an index outside
    ``[0, N)`` gathers a zero row whose node id is the index.  For a shard
    of a sharded state whose first row is global row ``base``, ``pidx``
    and ``gidx`` hold global row ids (an id outside the shard gathers a
    zero row)."""
    if pbuf.shape[0]:
        nodestate, victims, drain = apply_rows(
            nodestate, victims, drain, pidx.to(torch.int64) - base, pbuf)
    parts = [(nodestate, victims, drain)] if resident else []
    if gidx.shape[0]:
        n = nodestate.shape[1]
        idx = gidx.to(torch.int64) - base
        inr = (idx >= 0) & (idx < n)
        safe = torch.where(inr, idx, 0)
        ns = torch.where(inr[None], nodestate[:, safe], 0)
        ns[NS_NODE_ID] = gidx
        vv = torch.where(inr[None, :, None], victims[:, safe], 0)
        dd = torch.where(inr[None], drain[:, safe], 0)
        parts.append((ns, vv, dd))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(x, dim=1) for x in zip(*parts))


def class_sweep_plain(ns, v, dr, *, m: int, gate: bool, req: FusedRequest,
                      spec: ServerSpec) -> torch.Tensor:
    """Filtering + all-2^m-subset evaluation + per-(row, tier) reduction
    over rows ``(ns, v, dr)``: ``_fused_class_core`` with the freed masks as
    free | OR of the subset's slots.  Returns int32[`CLS_FIELDS`, rows]."""
    dev = ns.device
    sl = spec_slices(spec, dev)
    thresh, ng, nc, cpb = (req.thresh, req.need_gpus, req.need_cgs,
                           req.cgs_per_bundle)
    node_ids = ns[NS_NODE_ID]
    stored_full = v[VF_STORED] != 0
    vp_full = v[VF_PRIO]
    drain_tier, _, _ = best_tier_counts(dr[0], dr[1], ng, nc, cpb, sl)
    node_ok = (drain_tier < 3) & (node_ids < _INT32_MAX)
    if gate:
        elig_full = (stored_full & (vp_full < thresh)).sum(dim=1)
        node_ok &= (elig_full <= m) & ~((ns[NS_OVERFLOW] != 0)
                                        & (ns[NS_NEXT_PRIO] < thresh))
    n_comb = 1 << m
    cids = torch.arange(n_comb, dtype=torch.int32, device=dev)
    kk = popcount32(cids)
    slots = torch.arange(m, dtype=torch.int32, device=dev)
    bits = ((cids[None, :] >> slots[:, None]) & 1) != 0       # [m, n_comb]
    valid_slot = stored_full[:, :m] & (vp_full[:, :m] < thresh)
    valid_mask = (valid_slot.to(torch.int32) << slots).sum(
        dim=1, dtype=torch.int32)
    combo_ok = ((cids[None, :] & ~valid_mask[:, None]) == 0) & node_ok[:, None]

    rank = v[VF_RANK, :, :m]
    shift = MAX_DENSE_VICTIMS - 1 - rank
    rankbit = torch.where((shift >= 0) & (shift < 32),
                          torch.ones_like(rank) << shift.clamp(0, 31), 0)
    combo_g = ns[NS_FREE_GPU][:, None].expand(-1, n_comb)
    combo_c = ns[NS_FREE_CG][:, None].expand(-1, n_comb)
    prio = torch.zeros(combo_g.shape, dtype=torch.int64, device=dev)
    umask = torch.zeros_like(prio)
    for j in range(m):
        on = bits[j][None, :]
        combo_g = combo_g | torch.where(on, v[VF_GPU, :, j:j + 1], 0)
        combo_c = combo_c | torch.where(on, v[VF_CG, :, j:j + 1], 0)
        prio = prio + torch.where(on, vp_full[:, j:j + 1].to(torch.int64), 0)
        umask = umask + torch.where(on, rankbit[:, j:j + 1].to(torch.int64), 0)
    prio = prio.to(torch.int32)         # int32 wrap, as the int32 dot product
    umask = umask.to(torch.int32)
    tier, _, _ = best_tier_counts(combo_g, combo_c, ng, nc, cpb, sl)
    tier = torch.where(combo_ok, tier, 3)

    feasible = tier < 3
    k_node = torch.where(feasible, kk[None, :], m + 1).amin(dim=1)
    atmin = feasible & (kk[None, :] == k_node[:, None])
    cnt = atmin.sum(dim=1, dtype=torch.int32)
    p_eff = prio if req.alpha > 0 else torch.zeros_like(prio)
    out = torch.empty((CLS_FIELDS, ns.shape[1]), dtype=torch.int32,
                      device=dev)
    for t in range(3):
        sel = atmin & (tier == t)
        out[C_ANY + t] = sel.any(dim=1)
        pmin = torch.where(sel, p_eff, _INT32_MAX).amin(dim=1)
        sel = sel & (p_eff == pmin[:, None])
        umax = torch.where(sel, umask, -1).amax(dim=1)
        sel = sel & (umask == umax[:, None])
        cb = torch.argmax(sel.to(torch.int32), dim=1)      # first True, or 0
        out[C_CB + t] = cb
        out[C_PP + t] = prio.gather(1, cb[:, None])[:, 0]
        out[C_UM + t] = umask.gather(1, cb[:, None])[:, 0]
    out[C_K] = k_node
    out[C_CNT] = cnt
    out[C_NID] = node_ids
    return out


def fused_class_plain(nodestate, victims, drain, pidx, pbuf, gidx, *,
                      m_res: int, resident: bool, m_gather: int,
                      req: FusedRequest, spec: ServerSpec,
                      base: int = 0) -> torch.Tensor:
    """Plain version of `fused_class`: the resident section at ``m_res``
    behind the narrow gate, then the gathered section at ``m_gather``."""
    n_res = nodestate.shape[1] if resident else 0
    if n_res + gidx.shape[0] == 0:
        return torch.zeros((CLS_FIELDS, 0), dtype=torch.int32,
                           device=nodestate.device)
    ns, v, dr = plan_rows(nodestate, victims, drain, pidx, pbuf, gidx,
                          resident, base)
    parts = []
    if n_res:
        parts.append(class_sweep_plain(
            ns[:, :n_res], v[:, :n_res], dr[:, :n_res], m=m_res, gate=True,
            req=req, spec=spec))
    if ns.shape[1] > n_res:
        parts.append(class_sweep_plain(
            ns[:, n_res:], v[:, n_res:], dr[:, n_res:], m=m_gather,
            gate=False, req=req, spec=spec))
    return torch.cat(parts, dim=1)


def _scores(pp: torch.Tensor, alpha: float) -> torch.Tensor:
    """Eq. 1 in f32 for [rows, 3] priority sums, one rounding an operation:
    alpha rounded to f32, (1 - alpha) computed in double and rounded."""
    f32 = dict(dtype=torch.float32, device=pp.device)
    tier_vals = torch.tensor(TIER_SCORES, **f32)
    one = torch.ones(pp.shape, **f32)
    prio_term = torch.where(
        pp > 0, torch.div(one, torch.clamp(pp, min=1).to(torch.float32)), one)
    a = torch.tensor(np.float32(alpha), **f32)
    b = torch.tensor(np.float32(1.0 - alpha), **f32)
    return a * prio_term + b * tier_vals[None, :]


def _argmax_segment(cls, ns, v, req: FusedRequest, spec: ServerSpec):
    """``_fused_argmax_core`` + ``winner_place`` over one segment's rows."""
    dev = cls.device
    anyc = cls[C_ANY:C_ANY + 3].T != 0                       # [rows, 3]
    cb = cls[C_CB:C_CB + 3].T
    pp = cls[C_PP:C_PP + 3].T
    um = cls[C_UM:C_UM + 3].T
    k_node = cls[C_K]
    node_ids = cls[C_NID]
    big = _INT32_MAX
    score = torch.where(anyc, _scores(pp, req.alpha), -np.inf)
    sel = anyc & (score == score.max())
    tcol = torch.arange(3, dtype=torch.int32, device=dev)[None, :].expand(
        sel.shape)
    same_tier = (torch.where(sel, tcol, 3).min()
                 == torch.where(sel, tcol, -1).max())
    ppe = pp if req.alpha > 0 else torch.zeros_like(pp)
    ppe_key = torch.where(same_tier, ppe, 0)
    sel = sel & (ppe_key == torch.where(sel, ppe_key, big).min())
    kn = k_node[:, None].expand(sel.shape)
    sel = sel & (kn == torch.where(sel, kn, big).min())
    nid = node_ids[:, None].expand(sel.shape)
    sel = sel & (nid == torch.where(sel, nid, big).min())
    sel = sel & (um == torch.where(sel, um, -1).max())
    flat = torch.argmax(sel.reshape(-1).to(torch.int32))     # first True, or 0
    row = flat // 3
    t = flat % 3
    combo = cb.reshape(-1)[flat]
    slots = torch.arange(v.shape[2], dtype=torch.int32, device=dev)
    on = ((combo >> slots) & 1) != 0
    freed_g = ns[NS_FREE_GPU, row]
    freed_c = ns[NS_FREE_CG, row]
    for j in range(v.shape[2]):
        freed_g = freed_g | torch.where(on[j], v[VF_GPU, row, j], 0)
        freed_c = freed_c | torch.where(on[j], v[VF_CG, row, j], 0)
    _, _, p_g, p_c = place_core(freed_g, freed_c, req.need_gpus,
                                req.need_cgs, req.cgs_per_bundle, spec=spec)
    return torch.stack([
        anyc.any().to(torch.int32), row, t, combo, pp.reshape(-1)[flat],
        k_node[row], cls[C_CNT].sum(dtype=torch.int32), p_g, p_c,
    ]).to(torch.int32)


def fused_argmax_plain(cls, nodestate, victims, pidx, pbuf, gidx, *,
                       resident: bool, seg: int, req: FusedRequest,
                       spec: ServerSpec, base: int = 0,
                       shard: tuple[int, int, int] | None = None
                       ) -> torch.Tensor:
    """Plain version of `fused_argmax`: int32[segments, `WIN_FIELDS`], one
    Eq. 2 winner (with its placement) per segment of ``seg`` rows; with
    ``shard`` int32[segments, `PART_FIELDS`], the shard records."""
    drain = torch.zeros((2, nodestate.shape[1]), dtype=torch.int32,
                        device=nodestate.device)
    ns, v, _ = plan_rows(nodestate, victims, drain, pidx, pbuf, gidx,
                         resident, base)
    r = cls.shape[1]
    if shard is None:
        return torch.stack([
            _argmax_segment(cls[:, lo:lo + seg], ns[:, lo:lo + seg],
                            v[:, lo:lo + seg], req, spec)
            for lo in range(0, r, seg)])
    split, off_lo, off_hi = shard
    n_res = nodestate.shape[1] if resident else 0
    idx = gidx.to(torch.int64) - base
    real = torch.cat([torch.ones(n_res, dtype=torch.bool),
                      ((idx >= 0) & (idx < nodestate.shape[1])).cpu()])
    rows = torch.arange(r)
    glob = torch.where(rows < split, rows + off_lo, rows + off_hi)
    return torch.stack([
        _part_segment(cls[:, lo:lo + seg], ns[:, lo:lo + seg],
                      v[:, lo:lo + seg], glob[lo:lo + seg] - lo,
                      bool(real[lo]) and int(glob[lo]) == lo, req, spec)
        for lo in range(0, r, seg)]).to(cls.device)


def _place_entry(cls, ns, v, row: int, t: int, req: FusedRequest,
                 spec: ServerSpec) -> list[int]:
    """Row ``row``'s class ``t`` winner placed: (combo id, priority sum, k,
    gpu mask, cg mask), the tail's ``place_entry``."""
    combo = int(cls[C_CB + t, row])
    freed_g = int(ns[NS_FREE_GPU, row])
    freed_c = int(ns[NS_FREE_CG, row])
    for j in range(v.shape[2]):
        if (combo >> j) & 1:
            freed_g |= int(v[VF_GPU, row, j])
            freed_c |= int(v[VF_CG, row, j])
    i32 = dict(dtype=torch.int32)
    _, _, p_g, p_c = place_core(torch.tensor(freed_g, **i32),
                                torch.tensor(freed_c, **i32), req.need_gpus,
                                req.need_cgs, req.cgs_per_bundle, spec=spec)
    return [combo, int(cls[C_PP + t, row]), int(cls[C_K, row]), int(p_g),
            int(p_c)]


def _part_segment(cls, ns, v, glob, first: bool, req: FusedRequest,
                  spec: ServerSpec) -> torch.Tensor:
    """One segment's shard record (the kernel's ``kPartFields``): the
    tail's monoid state over the shard's entries, their flat indices from
    ``glob`` (each row's global place in the segment), the two tie keys'
    entries placed and the segment's first row placed (``first``: this
    shard holds the segment's first global row)."""
    cls, ns, v = cls.cpu(), ns.cpu(), v.cpu()
    anyc = cls[C_ANY:C_ANY + 3].T != 0
    pp = cls[C_PP:C_PP + 3].T
    score = torch.where(anyc, _scores(pp, req.alpha), -np.inf)
    cnt = int(cls[C_CNT].sum(dtype=torch.int32))
    ident = [_INT32_MAX, _INT32_MAX, _INT32_MAX, -1, _INT32_MAX]
    top = float(score.max()) if score.numel() else -np.inf
    out = [int(np.float32(top).view(np.int32)), 3, -1, cnt]
    keys = [ident, ident]
    if top > -np.inf:
        r, t = (anyc & (score == score.max())).nonzero().numpy().T
        c = cls.numpy().astype(np.int64)
        out[1:3] = [int(t.min()), int(t.max())]
        k, nid, um = c[C_K, r], c[C_NID, r], c[C_UM + t, r]
        flat = glob.numpy()[r] * 3 + t
        ppr = c[C_PP + t, r]
        for i, ppe in enumerate((ppr, np.zeros_like(ppr))):
            j = np.lexsort((flat, -um, nid, k, ppe))[0]
            keys[i] = [int(ppe[j]), int(k[j]), int(nid[j]), int(um[j]),
                       int(flat[j])]
    for key in keys:
        out.extend(key)
    rows = {g: r for r, g in enumerate(glob.tolist())}
    for key in keys:
        if key[4] == _INT32_MAX:
            out.extend([0, 0, 0, 0])
        else:
            e = _place_entry(cls, ns, v, rows[key[4] // 3], key[4] % 3,
                             req, spec)
            out.extend([e[0], e[1], e[3], e[4]])
    out.append(int(first))
    out.extend(_place_entry(cls, ns, v, 0, 0, req, spec))
    return torch.tensor(out, dtype=torch.int64).to(torch.int32)


# ---------------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------------

class _FusedParams(ctypes.Structure):
    """ctypes mirror of ``struct FusedParams`` in csrc/topo_score.cu: the
    lane kernels' TopoParams (request, NUMA layout, alpha) and what
    placement and the eligibility filter add."""

    _fields_ = [
        ("t", ts._Params),
        ("num_gpus", ctypes.c_int),
        ("num_cgs", ctypes.c_int),
        ("n_scopes", ctypes.c_int),
        ("scope_members", ctypes.c_int * _MAX_SCOPES),
        ("scope_tier", ctypes.c_int * _MAX_SCOPES),
        ("thresh", ctypes.c_int),
        ("alpha_pos", ctypes.c_int),
    ]


class _State(ctypes.Structure):
    """ctypes mirror of ``struct State`` in csrc/topo_score.cu."""

    _fields_ = [
        ("ns", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("dr", ctypes.c_void_p),
        ("pidx", ctypes.c_void_p),
        ("pbuf", ctypes.c_void_p),
        ("gidx", ctypes.c_void_p),
        ("n", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("p", ctypes.c_int),
        ("g", ctypes.c_int),
        ("n_res", ctypes.c_int),
        ("base", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=256)
def params(spec: ServerSpec, req: FusedRequest) -> _FusedParams:
    """The kernels' FusedParams for one SKU and request, built once per
    ``(spec, req)``."""
    p = _FusedParams()
    p.t = ts._params(spec, ts.TopoRequest(req.need_gpus, req.need_cgs,
                                          req.cgs_per_bundle, req.alpha))
    p.num_gpus = spec.num_gpus
    p.num_cgs = spec.num_coregroups
    sl = spec_slices(spec, "cpu")
    p.n_scopes = sl.scope_mask.shape[0]
    for sc in range(p.n_scopes):
        p.scope_members[sc] = sum(1 << u for u in range(spec.num_numa)
                                  if int(sl.scope_mask[sc, u]))
        p.scope_tier[sc] = int(sl.scope_tier[sc])
    p.thresh = int(np.int64(req.thresh).astype(np.int32))
    p.alpha_pos = int(req.alpha > 0)
    return p


@functools.lru_cache(maxsize=1024)
def cluster_geometry(rows: int, max_threads: int,
                     max_ctas: int = CLUSTER_CTAS) -> tuple[int, int]:
    """``(ctas, threads)`` of the one thread-block cluster that K2's
    normal-cycle form and K1's tail run over ``rows`` rows (the tail: a
    segment's): a CTA for every `CTA_ROWS` rows, at most ``max_ctas``
    (`max_cluster_ctas` on the card), and threads a CTA in whole warps, as
    many as give each row a thread, at most ``max_threads``.  A thread
    takes the rows ``rank * threads + thread + i * ctas * threads`` for
    i = 0, 1, ..., so every row is taken once (rows beyond ``ctas *
    threads`` loop)."""
    ctas = min(max_ctas, max(1, -(-rows // CTA_ROWS)))
    threads = min(max_threads, max(32, (-(-rows // ctas) + 31) // 32 * 32))
    return ctas, threads


@functools.lru_cache(maxsize=1024)
def sweep_geometry(m_res: int, res_rows: int, m_gather: int,
                   gather_rows: int, sms: int = 132) -> tuple[int, int, int]:
    """``(threads, group_res, group_gather)`` of the class sweep: a CTA of
    `WIDE_THREADS` a row when a section with rows is wider than
    `NARROW_KERNEL_M`.  Else a warp a row while the rows number at most
    `SWEEP_WARP_ROWS` a SM (the time is then one warp's chain, which two
    rows a warp would lengthen), and `SHARED_GROUP` threads a row above
    (fewer warps where the card is full); and as many warps a CTA (1 to 8)
    as put about `SWEEP_CTAS_PER_SM` CTAs on each of ``sms`` SMs, so a
    small plan spreads over the card and a large one fills it with few,
    full CTAs."""
    if max(m_res if res_rows else 0,
           m_gather if gather_rows else 0) > NARROW_KERNEL_M:
        return WIDE_THREADS, WIDE_THREADS, WIDE_THREADS
    group = (32 if res_rows + gather_rows <= SWEEP_WARP_ROWS * sms
             else SHARED_GROUP)
    warps = -(-(res_rows + gather_rows) * group // (32 * SWEEP_CTAS_PER_SM
                                                   * sms))
    return 32 * min(SWEEP_THREADS // 32, max(1, warps)), group, group


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def max_cluster_ctas(device: int) -> int:
    """The most CTAs a cluster of K2's normal-cycle form and of K1's tail
    takes on CUDA device ``device``: 16 where the card co-schedules such a
    cluster at the kernels' most threads and shared memory, else the
    portable `CLUSTER_CTAS`."""
    return lib().cluster_ctas_max(device)


#: checked launch states of recent calls (`launch_state`), least recently
#: used first
_STATES: dict = {}
#: enough for the launches of a plan over a sharded state of 8 shards
_MAX_STATES = 64


def launch_state(nodestate, victims, drain, pidx, pbuf, gidx,
                 resident: bool, base: int = 0) -> _State:
    """The kernels' State over contiguous int32 tensors on one CUDA device
    (``drain`` or ``gidx`` None where the kernel does not read it), for a
    shard of a sharded state whose first row is global row ``base`` (0
    unsharded).  It is checked once and kept by the tensors' identities
    and version counters, so a plan's launches and later plans on
    unchanged tensors reuse it, while any in-place change to one of them
    (data or shape) checks anew.  It holds the tensors, so their memory
    and identities outlive it."""
    xs = (nodestate, victims, drain, pidx, pbuf, gidx)
    try:
        key = (resident, base, *[(id(x), x._version) if x is not None
                                 else None for x in xs])
    except RuntimeError:        # an inference tensor has no version counter
        key = None
    st = _STATES.pop(key, None) if key is not None else None
    if st is None:
        st = _checked_state(*xs, resident, base)
        if key is not None and len(_STATES) >= _MAX_STATES:
            del _STATES[next(iter(_STATES))]
    if key is not None:
        _STATES[key] = st       # most recently used last
    return st


launch_state.cache_clear = _STATES.clear


def _checked_state(nodestate, victims, drain, pidx, pbuf, gidx,
                   resident: bool, base: int = 0) -> _State:
    dev = nodestate.device
    n = nodestate.shape[1]
    cap = victims.shape[2]
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, not {dev}")
    if not 0 <= base <= _INT32_MAX - n:
        raise ValueError(f"shard base {base} outside the int32 row range")
    if pbuf.shape[0] and pbuf.shape[1] != 5 + 5 * cap + 2:
        raise ValueError(f"patch rows are {pbuf.shape[1]} wide, expected "
                         f"{5 + 5 * cap + 2}")
    for name, x in (("nodestate", nodestate), ("victims", victims),
                    ("drain", drain), ("pidx", pidx), ("pbuf", pbuf),
                    ("gidx", gidx)):
        if x is None:
            continue
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the state on {dev}")
    if pidx.shape[0] != pbuf.shape[0]:
        raise ValueError("pidx and pbuf name different row counts")
    if pidx.shape[0] > MAX_PATCH_ROWS:
        raise ValueError(f"{pidx.shape[0]} patch rows; the kernels stage at "
                         f"most {MAX_PATCH_ROWS} in shared memory")
    s = _State()
    s.ns, s.v = nodestate.data_ptr(), victims.data_ptr()
    s.dr = drain.data_ptr() if drain is not None else None
    s.pidx = pidx.data_ptr() if pidx.shape[0] else None
    s.pbuf = pbuf.data_ptr() if pbuf.shape[0] else None
    s.gidx = gidx.data_ptr() if gidx is not None and gidx.shape[0] else None
    s.n, s.cap, s.p = n, cap, pidx.shape[0]
    s.g = gidx.shape[0] if gidx is not None else 0
    s.n_res = n if resident else 0
    s.base = base
    s.device = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    s.tensors = (nodestate, victims, drain, pidx, pbuf, gidx)
    return s


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The built ``csrc/topo_score.cu`` with the fused launchers' argument
    types declared."""
    return bind(ts._lib())


def bind(out: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the fused launchers' argument types on a loaded build of
    ``csrc/topo_score.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    sp, pp = ctypes.POINTER(_State), ctypes.POINTER(_FusedParams)
    out.fused_class_launch.argtypes = [sp, pp] + [ci] * 6 + [vp, vp, ci, vp]
    out.fused_argmax_launch.argtypes = [sp, pp, vp] + [ci] * 8 + [vp, vp,
                                                                  ci, vp]
    out.normal_cycle_launch.argtypes = [sp, pp, ci, ci, ci, vp, vp, ci, vp]
    out.normal_cycle_part_launch.argtypes = [sp, pp, ci, ci, ci, vp, ci, vp]
    out.normal_merge_launch.argtypes = [vp, ci, ci, ci, pp, vp, ci, vp]
    out.tail_merge_launch.argtypes = [vp, ci, ci, ci, vp, vp, ci, vp]
    out.prescreen_select_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp,
                                            vp, ci, vp]
    out.cluster_ctas_max.argtypes = [ci]
    out.empty_launch.argtypes = [vp]
    out.encode_delta_launch.argtypes = ([vp, vp, ci, ci, vp, ci, vp, ci, vp,
                                         vp, ci, ci, vp, ci, ci, vp])
    out.prescreen_launch.argtypes = [sp, pp, vp, vp, ci, ci, vp, vp, vp, vp,
                                     ci, vp]
    for fn in (out.fused_class_launch, out.fused_argmax_launch,
               out.normal_cycle_launch, out.cluster_ctas_max,
               out.empty_launch, out.encode_delta_launch,
               out.prescreen_launch, out.normal_cycle_part_launch,
               out.normal_merge_launch, out.tail_merge_launch,
               out.prescreen_select_launch):
        fn.restype = ci
    out.topo_score_error_string.argtypes = [ci]
    out.topo_score_error_string.restype = ctypes.c_char_p
    return out


def on_cuda(*xs: torch.Tensor) -> bool:
    """Whether the tensors lie on a CUDA device; raises where some do and
    some do not, or where they lie on neither a CUDA device nor the CPU.
    That they share one CUDA device `launch_state` checks."""
    cuda = xs[0].is_cuda
    if any(x.is_cuda != cuda for x in xs):
        raise ValueError("tensors on different devices")
    if not cuda:
        for x in xs:
            if x.device.type != "cpu":
                raise ValueError(f"unsupported device {x.device}")
    return cuda


def stream_of(st: _State) -> int:
    """PyTorch's current stream on the state's device."""
    return torch.cuda.current_stream(st.device).cuda_stream


def fused_class(nodestate, victims, drain, pidx, pbuf, gidx, *, m_res: int,
                resident: bool, m_gather: int, req: FusedRequest,
                spec: ServerSpec, skip: torch.Tensor | None = None,
                out: torch.Tensor | None = None,
                base: int = 0) -> torch.Tensor:
    """The class sweep over every row of a plan in one launch: int32
    [`CLS_FIELDS`, rows] (rows = N if ``resident`` else 0, plus
    ``len(gidx)``), written into ``out`` (contiguous) when given.  With
    ``skip`` set the sweep does nothing and its output is undefined.
    ``base``: the tensors are a shard whose first row is global row
    ``base`` (`plan_rows`).  Counterpart of ``_fused_class_core``."""
    rows = (nodestate.shape[1] if resident else 0) + gidx.shape[0]
    if out is not None and (out.shape != (CLS_FIELDS, rows)
                            or out.dtype != torch.int32
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 [{CLS_FIELDS}, "
                         f"{rows}] tensor")
    if not on_cuda(nodestate, victims, drain, pidx, pbuf, gidx):
        if skip is not None and int(skip.reshape(-1)[0]):
            got = torch.zeros((CLS_FIELDS, rows), dtype=torch.int32)
        else:
            got = fused_class_plain(nodestate, victims, drain, pidx, pbuf,
                                    gidx, m_res=m_res, resident=resident,
                                    m_gather=m_gather, req=req, spec=spec,
                                    base=base)
        if out is None:
            return got
        out.copy_(got)
        return out
    st = launch_state(nodestate, victims, drain, pidx, pbuf, gidx, resident,
                      base)
    return launch_class(st, m_res, m_gather, req, spec, skip, out=out)


def launch_class(st, m_res: int, m_gather: int, req: FusedRequest,
                 spec: ServerSpec, skip: torch.Tensor | None = None,
                 geometry: tuple[int, int, int] | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The sweep on a `launch_state`, in `sweep_geometry` unless
    ``geometry`` ``(threads, group_res, group_gather)`` is given (every
    geometry the launcher takes gives the same bits; a forced one serves
    the checks and measurements of each), into ``out`` when given."""
    n_res, n_gather = st.n_res, st.g
    rows = n_res + n_gather
    cls = out if out is not None else torch.empty(
        (CLS_FIELDS, rows), dtype=torch.int32, device=st.tensors[0].device)
    if cls.device != st.tensors[0].device:
        raise ValueError(f"out is on {cls.device}, the state on "
                         f"{st.tensors[0].device}")
    if rows == 0:
        return cls
    threads, g_res, g_gather = geometry or sweep_geometry(
        m_res, n_res, m_gather, n_gather, sm_count(st.device))
    lb = lib()
    code = lb.fused_class_launch(
        ctypes.byref(st), ctypes.byref(params(spec, req)), m_res, m_gather,
        rows, threads, g_res, g_gather,
        None if skip is None else skip.data_ptr(), cls.data_ptr(), st.device,
        stream_of(st))
    ts._raise_on(lb, code, "fused_class")
    fused_class.launches += 1
    return cls


fused_class.launches = 0


def fused_argmax(cls, nodestate, victims, pidx, pbuf, gidx, *,
                 resident: bool, seg: int, req: FusedRequest,
                 spec: ServerSpec, skip: torch.Tensor | None = None,
                 out: torch.Tensor | None = None, base: int = 0,
                 shard: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The Eq. 2 argmax and the winner's placement, one per segment of
    ``seg`` rows of ``cls``: int32[segments, `WIN_FIELDS`] (written into
    ``out`` when given).  With ``skip`` set every winner is zeros.
    Counterpart of ``_fused_argmax_core`` + ``winner_place``.

    A shard of a sharded state (first row ``base``) passes ``shard =
    (split, off_lo, off_hi)``: a row's global place in its segment is its
    local place plus ``off_lo`` below row ``split`` and ``off_hi`` from it,
    and the output is the shard's records, int32[segments, `PART_FIELDS`],
    which `tail_merge` merges across the shards."""
    rows = cls.shape[1]
    segs = -(-rows // seg)
    width = WIN_FIELDS if shard is None else PART_FIELDS
    if not on_cuda(cls, nodestate, victims, pidx, pbuf, gidx):
        if skip is not None and int(skip.reshape(-1)[0]):
            got = torch.zeros((segs, width), dtype=torch.int32)
        else:
            got = fused_argmax_plain(cls, nodestate, victims, pidx, pbuf,
                                     gidx, resident=resident, seg=seg,
                                     req=req, spec=spec, base=base,
                                     shard=shard)
        if out is None:
            return got
        out.view(segs, width).copy_(got)
        return out
    st = launch_state(nodestate, victims, None, pidx, pbuf, gidx, resident,
                      base)
    if out is None:
        out = torch.empty((segs, width), dtype=torch.int32,
                          device=cls.device)
    if (out.numel() != segs * width or out.dtype != torch.int32
            or not out.is_contiguous()):
        raise ValueError(f"out must hold {segs} x {width} int32")
    if rows == 0:
        return out
    if (cls.dtype != torch.int32 or not cls.is_contiguous()
            or not cls.device == out.device == nodestate.device):
        raise ValueError("cls must be a contiguous int32 tensor beside out "
                         "and the state")
    ctas, threads = cluster_geometry(min(seg, rows), TAIL_THREADS,
                                     max_cluster_ctas(st.device))
    lb = lib()
    split, off_lo, off_hi = shard or (0, 0, 0)
    code = lb.fused_argmax_launch(
        ctypes.byref(st), ctypes.byref(params(spec, req)),
        cls.data_ptr(), rows, seg, ctas, threads, int(shard is not None),
        split, off_lo, off_hi, None if skip is None else skip.data_ptr(),
        out.data_ptr(), st.device, stream_of(st))
    ts._raise_on(lb, code, "fused_argmax")
    fused_argmax.launches += 1
    return out


fused_argmax.launches = 0

def tail_merge_plain(part: torch.Tensor, alpha_pos: bool) -> torch.Tensor:
    """Plain version of `tail_merge`: int32[segments, `WIN_FIELDS`] from
    the shards' records int32[D, segments, `PART_FIELDS`]."""
    recs = part.cpu().numpy().astype(np.int64)
    out = []
    for sg in range(recs.shape[1]):
        rs = recs[:, sg]
        scores = rs[:, 0].astype(np.int32).view(np.float32)
        cnt = int(rs[:, 3].sum()) & 0xFFFFFFFF       # wraps as uint32
        cnt -= (cnt >> 31) << 32
        top = scores.max()
        if top == -np.inf:
            real = [d for d in range(len(rs)) if rs[d, 22]]
            w = rs[real[0] if real else 0]
            out.append([0, 0, 0, w[23], w[24], w[25], cnt, w[26], w[27]])
            continue
        at = scores == top
        tmin, tmax = rs[at, 1].min(), rs[at, 2].max()
        use_a = tmin == tmax and alpha_pos
        ko = 4 if use_a else 9
        keys = [tuple(r[ko:ko + 5]) for r in rs[at]]
        best = min(keys, key=lambda e: (e[0], e[1], e[2], -e[3], e[4]))
        w = next(r for r in rs if r[ko + 4] == best[4])
        eo = 14 if use_a else 18
        flat = int(best[4])
        out.append([1, flat // 3, flat % 3, w[eo], w[eo + 1], best[1], cnt,
                    w[eo + 2], w[eo + 3]])
    return torch.tensor(out, dtype=torch.int64).reshape(
        -1, WIN_FIELDS).to(torch.int32).to(part.device)


def tail_merge(part: torch.Tensor, *, alpha: float,
               skip: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The shards' tail records (int32[D, segments, `PART_FIELDS`], each
    shard's `fused_argmax` with ``shard=``) merged into each segment's
    winner, int32[segments, `WIN_FIELDS`]: exactly what the tail gives
    over the unsharded rows.  The records hold the tail's exact monoid
    state, so the tie chain's same-tier test is taken over every shard's
    survivors.  With ``skip`` set every winner is zeros.  Written into
    ``out`` when given.  Its kernel, ``tail_merge_kernel``, stands in for
    the cross-shard collectives XLA inserts into the reference's sharded
    ``_fused_argmax_core`` + ``winner_place``."""
    if part.dim() != 3 or part.shape[2] != PART_FIELDS or not part.shape[0]:
        raise ValueError(f"part must be [D, segments, {PART_FIELDS}]")
    segs = part.shape[1]
    if not on_cuda(part, *([] if skip is None else [skip])):
        if skip is not None and int(skip.reshape(-1)[0]):
            got = torch.zeros((segs, WIN_FIELDS), dtype=torch.int32)
        else:
            got = tail_merge_plain(part, alpha > 0)
        if out is None:
            return got
        out.view(segs, WIN_FIELDS).copy_(got)
        return out
    if part.dtype != torch.int32 or not part.is_contiguous():
        raise ValueError("part must be a contiguous int32 tensor")
    if out is None:
        out = torch.empty((segs, WIN_FIELDS), dtype=torch.int32,
                          device=part.device)
    if (out.numel() != segs * WIN_FIELDS or out.device != part.device
            or out.dtype != torch.int32 or not out.is_contiguous()
            or (skip is not None and skip.device != part.device)):
        raise ValueError("out and skip must lie beside part")
    lb = lib()
    device = part.device.index if part.device.index is not None else \
        torch.cuda.current_device()
    code = lb.tail_merge_launch(
        part.data_ptr(), part.shape[0], segs, int(alpha > 0),
        None if skip is None else skip.data_ptr(), out.data_ptr(), device,
        torch.cuda.current_stream(part.device).cuda_stream)
    ts._raise_on(lb, code, "tail_merge")
    tail_merge.launches += 1
    return out


tail_merge.launches = 0

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (fused_class, fused_argmax, tail_merge)

__all__ = ["CLS_FIELDS", "CLUSTER_CTAS", "FusedRequest", "IDX_SENTINEL",
           "CTA_ROWS", "MAX_PATCH_ROWS", "NORMAL_THREADS", "PART_FIELDS",
           "TAIL_THREADS",
           "WIN_FIELDS", "WRAPPERS", "bind", "class_sweep_plain",
           "cluster_geometry", "fused_argmax", "fused_argmax_plain",
           "fused_class", "fused_class_plain", "launch_state",
           "launch_class", "max_cluster_ctas", "plan_rows", "sm_count",
           "sweep_geometry", "SHARED_GROUP", "SWEEP_THREADS",
           "SWEEP_WARP_ROWS", "WIDE_THREADS", "tail_merge",
           "tail_merge_plain"]
