"""The fused ``imp_batched`` engine: Algorithm 1 over the device-resident state.

Counterpart of the single-request path of the reference's
``repro.core.preemption_jax``.  One plan runs over the cluster's
`DeviceClusterState` (``Cluster.device_state``) as a chain of three kernel
launches in stream order and ONE readback of ``int32[5 + WIN_FIELDS]``:

1. ``kernels.normal_cycle`` (K2, normal-cycle form): the normal cycle over
   every node — count screen, placement tier, blind tier, the exact
   ``(tier, leftover, node)`` argmin and the winner's masks;
2. ``kernels.fused_class.fused_class`` (K1, resident form): Guaranteed
   Filtering on the drain masks, the narrow gate, and every victim subset
   of every row, reduced to per-(row, tier) class winners;
3. ``kernels.fused_class.fused_argmax`` (K1's tail): the Eq. 2 argmax with
   its exact tie chain and the winner's placement.

Launches 2 and 3 read the normal cycle's ``found`` on the device and return
at once when it is set (the reference's ``lax.cond``).  A copy-on-write
`ClusterView`'s delta rows (encoded on the host by ``encode_row``) and the
rows ``sync(flush=False)`` left pending ride the launches as patch rows;
the resident tensors are never written by a plan.

The host routes rows by their eligible victims (`split_fused_nodes`): the
main launch sweeps every resident row at an adaptive width ``m_res`` (4 or
`NARROW_M`) plus the gathered mid rows at `NARROW_M`; rows with 9–16
eligible victims are swept afterwards in chunks of `MAX_ROWS_WIDE` at 16
slots, only once the readback shows that the normal cycle failed; truncated
rows whose eligible victims extend past the stored prefix fall back to host
``flextopo_imp``.  Candidates of every dispatch meet in the exact host
``select_best``, as in the reference.

On CPU tensors every wrapper runs its plain PyTorch version, so
``TopoScheduler(Cluster(..., device="cpu"), engine="imp_batched")`` runs the
same chain without a card.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.fused_class import (C_ANY, C_CB, C_CNT, C_K, C_PP,
                                             C_UM, WIN_FIELDS, FusedRequest,
                                             fused_argmax, fused_class)
from repro_torch.kernels.normal_cycle import NORMAL_FIELDS, normal_cycle

from .cluster import (IDX_SENTINEL, Cluster, DeviceClusterState, VictimRow,
                      encode_row, flatten_rows, pack_context_rows, pack_rows,
                      pad_idx, row_width)
from .engines import register_engine
from .placement import Placement
from .scoring import DEFAULT_ALPHA, Candidate, select_best
from .topology import ServerSpec
from .workload import TopoPolicy, WorkloadSpec

#: victim-slot width of the resident sweep; rows with more eligible victims
#: are gated out on the device and re-dispatched wide
NARROW_M = 8
#: smallest victim-slot width of the adaptive resident sweep
MIN_M = 4
#: rows per wide (16-slot, 65536-subset) chunk; each chunk has its own winner
MAX_ROWS_WIDE = 16

__all__ = ["CandidateShortlist", "ClassWinners", "FusedPlanResult",
           "FusedSplit", "IDX_SENTINEL", "MAX_ROWS_WIDE", "MIN_M", "NARROW_M",
           "WIN_FIELDS", "plan_fused", "plan_normal_fused",
           "source_candidates_fused", "split_fused_nodes", "warmup_fused"]


class ClassWinners(NamedTuple):
    """Per-(row, tier) class winners of the sweep, unpacked from its
    int32[`CLS_FIELDS`, rows] output: ``anyc [rows, 3]`` marks classes that
    hold a min-k feasible subset; ``cb``/``pp``/``um`` are the class
    winner's combo id, priority sum and uid-rank mask; ``k_node [rows]`` is
    each row's smallest feasible subset size and ``cnt [rows]`` its count
    of feasible subsets at that size."""

    anyc: torch.Tensor
    cb: torch.Tensor
    pp: torch.Tensor
    um: torch.Tensor
    k_node: torch.Tensor
    cnt: torch.Tensor

    @classmethod
    def of(cls, out: torch.Tensor) -> "ClassWinners":
        return cls(anyc=out[C_ANY:C_ANY + 3].T != 0,
                   cb=out[C_CB:C_CB + 3].T, pp=out[C_PP:C_PP + 3].T,
                   um=out[C_UM:C_UM + 3].T, k_node=out[C_K], cnt=out[C_CNT])


class CandidateShortlist(list):
    """``list[Candidate]`` that also reports the TRUE candidate count.

    The fused engine returns only per-dispatch winners, but the device
    counted every feasible min-k subset; ``n_candidates`` carries that count
    so ``SchedulingDecision.num_candidates`` stays comparable with the
    exhaustive-listing engines.  ``placements`` maps ``(node, victims)`` of
    device-decoded winners to the `Placement` the tail computed; the
    scheduler binds those masks instead of re-running host ``place()``.
    """

    n_candidates: int = 0

    def __init__(self, *args) -> None:
        super().__init__(*args)
        self.placements: dict[tuple[int, tuple[int, ...]], Placement] = {}


def _req_scalars(spec: ServerSpec, workload: WorkloadSpec):
    """(need_gpus, need_cgs, cgs_per_bundle) of a preemptor."""
    ng = workload.gpus_per_instance
    nc = workload.coregroups_per_instance(spec.coregroup_size)
    bundle = workload.numa_policy == TopoPolicy.GUARANTEED
    return ng, nc, (nc // ng if (bundle and ng) else 0)


def _request(spec: ServerSpec, workload: WorkloadSpec,
             alpha: float) -> FusedRequest:
    return FusedRequest(workload.priority, *_req_scalars(spec, workload),
                        float(alpha))


def _overflow_candidates(cluster, workload: WorkloadSpec,
                         nodes: list[int]) -> list[Candidate]:
    from .preemption import flextopo_imp

    out: list[Candidate] = []
    for node in nodes:
        out.extend(flextopo_imp(cluster, workload, node))
    return out


def _pad_idx(ids, floor: int = 4) -> np.ndarray:
    """`cluster.pad_idx` with the dispatch paths' minimum bucket of 4."""
    return pad_idx(ids, floor)


def _pack_patches(patches: dict[int, VictimRow], cap: int):
    """View-delta rows as ``(p, pidx, pbuf)``: node ids ascending, one
    flattened int32 buffer, both padded to a power of two (`_pad_idx`) with
    `IDX_SENTINEL` rows last; ``p`` = 0 without patches."""
    return _patch_rows(patches, None, (), cap)


def _patch_rows(rows: dict[int, VictimRow], ctx, pending, cap: int):
    width = row_width(cap)
    ids, bufs = [], []
    if rows:
        nodes = sorted(rows)
        ids.extend(nodes)
        bufs.append(flatten_rows(*pack_rows([rows[n] for n in nodes], nodes,
                                            cap)))
    if pending:
        ids.extend(pending)
        bufs.append(flatten_rows(*pack_context_rows(ctx, pending)))
    if not ids:
        return 0, np.zeros(0, np.int32), np.zeros((0, width), np.int32)
    buf = np.concatenate(bufs) if len(bufs) > 1 else bufs[0]
    order = np.argsort(np.asarray(ids, np.int64), kind="stable")
    idx = _pad_idx(np.asarray(ids, np.int32)[order])
    pbuf = np.zeros((len(idx), width), np.int32)
    pbuf[:len(ids)] = buf[order]
    return len(idx), idx, pbuf


def _patch_args(dcs: DeviceClusterState, patches: dict[int, VictimRow]):
    """One patch buffer covering the view's delta rows (``patches``, a
    ``{node: VictimRow}`` dict) AND the device state's unflushed
    ``pending`` rows: both classes of stale row ride the same launches,
    so a plan pays one host→device upload and no standalone scatter.
    Returns ``(p, pidx, pbuf)`` as host arrays, ``pidx`` ascending (the
    kernels search it) and padded with `IDX_SENTINEL`."""
    pending = sorted(set(dcs.pending) - set(patches))
    return _patch_rows(patches, dcs.mirror, pending, dcs.cap)


class FusedSplit(NamedTuple):
    """Host routing decision for one fused sourcing call.

    ``m_res`` is the victim-slot width of the MAIN sweep (adaptive: `MIN_M`
    when at most `MAX_ROWS_WIDE` rows hold more eligible victims); ``mid``
    holds the rows with m_res < eligible <= `NARROW_M` (gathered at
    `NARROW_M`), ``wide`` the 9..16-eligible rows (16-slot chunks) and
    ``overflow`` the truncated rows whose eligible victims extend past the
    stored prefix (host ``flextopo_imp``)."""

    m_res: int
    mid: list
    wide: list
    overflow: list


def split_fused_nodes(dcs: DeviceClusterState, patches: dict, thresh: int,
                      nodes=None) -> FusedSplit:
    """Route rows between the main sweep and its re-dispatch tiers.

    Eligible victims are a prefix of each (priority, uid)-sorted row, so
    every row is classified by one vectorized count over the host mirror
    (patched rows overridden); the main sweep's width adapts.  When no
    node stores more than `MIN_M` victims (``dcs.count_max``) the scan is
    skipped.
    """
    ctx = dcs.mirror
    patch_big = [n for n, r in patches.items() if r.count > MIN_M]
    if dcs.count_max <= MIN_M and not patch_big:
        return FusedSplit(MIN_M, [], [], [])
    n = dcs.cluster.num_nodes
    elig = ((ctx.vp < thresh) & ctx.stored).sum(axis=1)
    bad = ctx.overflow & (ctx.next_prio < thresh)
    for node, r in patches.items():
        elig[node] = int(((r.vp < thresh) & r.stored).sum())
        bad[node] = bool(r.overflow and r.next_priority < thresh)
    if nodes is None:
        allowed = np.ones(n, bool)
    else:
        allowed = np.zeros(n, bool)
        allowed[list(nodes)] = True
    ok = allowed & ~bad
    m_res = (MIN_M if int((ok & (elig > MIN_M)).sum()) <= MAX_ROWS_WIDE
             else NARROW_M)
    mid = np.nonzero(ok & (elig > m_res) & (elig <= NARROW_M))[0].tolist()
    wide = np.nonzero(ok & (elig > NARROW_M))[0].tolist()
    overflow = np.nonzero(allowed & bad)[0].tolist()
    return FusedSplit(m_res, mid, wide, overflow)


def _append_winner(out: CandidateShortlist, vals, sel_nodes, patches, ctx):
    """Decode one dispatch's `WIN_FIELDS` winner (host ints) into a host
    `Candidate` plus its device-computed `Placement`."""
    found, row, tier, combo, prio, _k, ncand, pgm, pcm = (int(x)
                                                          for x in vals)
    out.n_candidates += ncand
    if not found:
        return
    if sel_nodes is None:
        node = row                            # resident row index == node
    elif isinstance(sel_nodes, dict):
        node = int(sel_nodes.get(row, row))   # resident + mid rows
    else:
        node = int(sel_nodes[row])            # gathered chunk
    vu = patches[node].vu if node in patches else ctx.vu[node]
    uids = [int(vu[j]) for j in range(len(vu)) if (combo >> j) & 1]
    victims = tuple(sorted(uids))
    out.append(Candidate(node=node, victims=victims, tier=tier,
                         priority_sum=prio))
    out.placements[(node, victims)] = Placement(
        gpu_mask=pgm & 0xFFFFFFFF, cg_mask=pcm & 0xFFFFFFFF, tier=tier)


def _upload(dcs: DeviceClusterState, x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dcs.device)


def _empty_patch_args(dcs: DeviceClusterState):
    """Zero-row patch tensors on the state's device, made once."""
    got = dcs.plan_cache.get("empty")
    if got is None:
        got = dcs.plan_cache["empty"] = (
            _upload(dcs, np.zeros(0, np.int32)),
            _upload(dcs, np.zeros((0, row_width(dcs.cap)), np.int32)))
    return got


def _fast_plan_args(dcs: DeviceClusterState, patches: dict, thresh: int,
                    p: int, pidx, pbuf):
    """Routing split + the device index/patch tensors of a ``nodes=None``
    plan: ``(split, pidx_d, pbuf_d, gidx_d)``.  The patch-free case
    (``p`` == 0) is cached per preemptor priority on the
    `DeviceClusterState`, keyed by its invalidation ``version``: repeated
    plans against unchanged state skip the host eligibility scan and the
    uploads."""
    cached = dcs.plan_cache.get(thresh) if p == 0 else None
    if cached is not None and cached[0] == dcs.version:
        return cached[1:]
    split = split_fused_nodes(dcs, patches, thresh)
    gidx = _pad_idx(split.mid) if split.mid else np.zeros(0, np.int32)
    aux = _upload(dcs, np.concatenate([pidx, gidx]).astype(np.int32))
    got = (split, aux[:p], _upload(dcs, pbuf), aux[p:])
    if p == 0:
        dcs.plan_cache[thresh] = (dcs.version,) + got
    return got


# ---------------------------------------------------------------------------------
# The pipelines: chains of kernel launches, no host round trip inside
# ---------------------------------------------------------------------------------

def _state(dcs: DeviceClusterState):
    return dcs.nodestate, dcs.victims, dcs.drain


def _sorting_winner(dcs, pidx, pbuf, gidx, req: FusedRequest, spec, m: int,
                    skip=None, out=None) -> torch.Tensor:
    """Filtering → subset sweep over every resident row at width ``m`` plus
    the gathered `NARROW_M`-wide rows ``gidx`` → Eq. 2 argmax → the
    winner's placement: int32[1, `WIN_FIELDS`]."""
    ns, v, dr = _state(dcs)
    cls = fused_class(ns, v, dr, pidx, pbuf, gidx, m_res=m, resident=True,
                      m_gather=NARROW_M, req=req, spec=spec, skip=skip)
    return fused_argmax(cls, ns, v, pidx, pbuf, gidx, resident=True,
                        seg=cls.shape[1], req=req, spec=spec, skip=skip,
                        out=out)


def _plan_pipeline(dcs, pidx, pbuf, gidx, req, spec, m) -> torch.Tensor:
    """The preemption phase alone: two launches, int32[`WIN_FIELDS`]."""
    return _sorting_winner(dcs, pidx, pbuf, gidx, req, spec, m)[0]


def _plan2_pipeline(dcs, pidx, pbuf, gidx, req, spec, m) -> torch.Tensor:
    """BOTH cycles of Algorithm 1: the normal cycle writes out[:5]; the
    sweep and its tail read out[0] on the device and return at once when
    it is set.  Returns int32[5 + `WIN_FIELDS`]."""
    ns, v, dr = _state(dcs)
    out = torch.empty(NORMAL_FIELDS + WIN_FIELDS, dtype=torch.int32,
                      device=ns.device)
    normal_cycle(ns, v, dr, pidx, pbuf, req=req, spec=spec,
                 out=out[:NORMAL_FIELDS])
    _sorting_winner(dcs, pidx, pbuf, gidx, req, spec, m,
                    skip=out[:1], out=out[NORMAL_FIELDS:])
    return out


def _normal_pipeline(dcs, pidx, pbuf, req, spec) -> torch.Tensor:
    """The normal cycle alone: one launch, int32[5]."""
    ns, v, dr = _state(dcs)
    return normal_cycle(ns, v, dr, pidx, pbuf, req=req, spec=spec)


def _gathered_pipeline(dcs, pidx, pbuf, gidx, req, spec, m: int,
                       seg: int) -> torch.Tensor:
    """The rows named by ``gidx`` (no resident section, no gate) at width
    ``m``, one winner per segment of ``seg`` rows: int32[segs,
    `WIN_FIELDS`].  `IDX_SENTINEL` entries are zero rows that never win."""
    ns, v, dr = _state(dcs)
    cls = fused_class(ns, v, dr, pidx, pbuf, gidx, m_res=m, resident=False,
                      m_gather=m, req=req, spec=spec)
    return fused_argmax(cls, ns, v, pidx, pbuf, gidx, resident=False,
                        seg=seg, req=req, spec=spec)


def _chunked(dcs, pidx_d, pbuf_d, rows: list[int], req, spec, m: int):
    """``rows`` in chunks of `MAX_ROWS_WIDE` (each padded with
    `IDX_SENTINEL` to a full chunk), swept in one launch with one winner a
    chunk.  Returns ``[(vals, chunk), ...]`` after one readback."""
    if not rows:
        return []
    chunks = [rows[lo:lo + MAX_ROWS_WIDE]
              for lo in range(0, len(rows), MAX_ROWS_WIDE)]
    gidx = np.full(len(chunks) * MAX_ROWS_WIDE, IDX_SENTINEL, np.int32)
    for i, chunk in enumerate(chunks):
        gidx[i * MAX_ROWS_WIDE:i * MAX_ROWS_WIDE + len(chunk)] = chunk
    res = _gathered_pipeline(dcs, pidx_d, pbuf_d, _upload(dcs, gidx), req,
                             spec, m, MAX_ROWS_WIDE)
    return list(zip(res.tolist(), chunks))


# ---------------------------------------------------------------------------------
# Engine entry points
# ---------------------------------------------------------------------------------

def _view_patches_of(cluster, dcs: DeviceClusterState) -> dict:
    """Delta rows of a `ClusterView` as ``{node: VictimRow}`` ({} for the
    base cluster), encoded on the host by ``encode_row``."""
    if not hasattr(cluster, "delta_nodes"):
        return {}
    return {d: encode_row(cluster, d, dcs.cap)
            for d in sorted(cluster.delta_nodes())}


def _device_state(cluster) -> DeviceClusterState:
    base = getattr(cluster, "base", cluster)
    # flush=False: small dirty sets stay pending and ride the launches as
    # patch rows instead of paying a standalone scatter
    return base.device_state().sync(flush=False)


def source_candidates_fused(cluster, workload: WorkloadSpec,
                            nodes: list[int] | None = None,
                            alpha: float = DEFAULT_ALPHA
                            ) -> CandidateShortlist:
    """Fused cluster-wide IMP over the device-resident state.

    ``nodes=None`` (the scheduler's ``fused_filter`` path) runs Guaranteed
    Filtering, the subset sweep and the Eq. 2 argmax over ALL rows: the
    resident sweep and its tail (two launches), then the wide chunks.  An
    explicit node list gathers exactly those rows instead (narrow, mid and
    wide dispatches).  Returns the winning `Candidate` of each dispatch
    (plus host candidates of overflow rows) as a `CandidateShortlist`
    carrying the true evaluated-candidate count.
    """
    if nodes is not None and not nodes:
        return CandidateShortlist()
    spec = cluster.spec
    dcs = _device_state(cluster)
    ctx = dcs.mirror
    req = _request(spec, workload, alpha)
    if nodes is None:
        patches = _view_patches_of(cluster, dcs)
    else:
        delta = (set(cluster.delta_nodes()) & set(nodes)
                 if hasattr(cluster, "delta_nodes") else set())
        patches = {d: encode_row(cluster, d, ctx.cap) for d in sorted(delta)}
    p, pidx, pbuf = _patch_args(dcs, patches)
    pending = []      # (vals, sel) per dispatch, decoded together
    if nodes is None:
        split, pidx_d, pbuf_d, gidx_d = _fast_plan_args(dcs, patches,
                                                        workload.priority,
                                                        p, pidx, pbuf)
        out = CandidateShortlist(_overflow_candidates(cluster, workload,
                                                      split.overflow))
        res = _plan_pipeline(dcs, pidx_d, pbuf_d, gidx_d, req, spec,
                             split.m_res)
        n = dcs.n_rows
        sel = ({n + j: node for j, node in enumerate(split.mid)}
               if split.mid else None)
        pending.append((res.tolist(), sel))
        pending.extend(_chunked(dcs, pidx_d, pbuf_d, split.wide, req, spec,
                                ctx.cap))
    else:
        split = split_fused_nodes(dcs, patches, workload.priority, nodes)
        out = CandidateShortlist(_overflow_candidates(cluster, workload,
                                                      split.overflow))
        pidx_d, pbuf_d = _upload(dcs, pidx), _upload(dcs, pbuf)
        excluded = set(split.mid) | set(split.wide) | set(split.overflow)
        narrow = [c for c in nodes if c not in excluded]
        if narrow:
            res = _gathered_pipeline(dcs, pidx_d, pbuf_d,
                                     _upload(dcs, _pad_idx(narrow)), req,
                                     spec, split.m_res,
                                     len(_pad_idx(narrow)))
            pending.append((res[0].tolist(), narrow))
        pending.extend(_chunked(dcs, pidx_d, pbuf_d, split.mid, req, spec,
                                NARROW_M))
        pending.extend(_chunked(dcs, pidx_d, pbuf_d, split.wide, req, spec,
                                ctx.cap))
    out.n_candidates = len(out)
    for vals, sel in pending:
        _append_winner(out, vals, sel, patches, ctx)
    return out


@dataclasses.dataclass
class FusedPlanResult:
    """Decoded outcome of one chained normal + preemptive plan.

    ``placement`` carries the tail's masks; a ``None`` placement on a
    preempted result (host-fallback winner) tells the scheduler to place
    on the host instead."""

    kind: str                               # placed | preempted | rejected
    node: int = -1
    placement: Placement | None = None
    victims: tuple[int, ...] = ()
    n_candidates: int = 0


def plan_normal_fused(cluster, workload: WorkloadSpec):
    """The normal scheduling cycle as ONE launch over the resident node
    state (view deltas and pending rows read as patch rows).  Returns
    ``(node, Placement)`` or ``None``."""
    spec = cluster.spec
    dcs = _device_state(cluster)
    patches = _view_patches_of(cluster, dcs)
    p, pidx, pbuf = _patch_args(dcs, patches)
    if p == 0:
        pidx_d, pbuf_d = _empty_patch_args(dcs)
    else:
        pidx_d, pbuf_d = _upload(dcs, pidx), _upload(dcs, pbuf)
    res = _normal_pipeline(dcs, pidx_d, pbuf_d,
                           _request(spec, workload, DEFAULT_ALPHA), spec)
    found, node, tier, gm, cm = res.tolist()
    if not found:
        return None
    return node, Placement(gpu_mask=gm & 0xFFFFFFFF,
                           cg_mask=cm & 0xFFFFFFFF, tier=tier)


def _finalize_plan(vals, sel, patches, ctx, shortlist_fn, wide_chunks_fn,
                   alpha: float) -> FusedPlanResult:
    """Decode a chained plan's int32[5 + `WIN_FIELDS`] readback.

    ``shortlist_fn`` builds the base `CandidateShortlist` (host-fallback
    overflow candidates) and ``wide_chunks_fn`` runs the wide chunks — both
    only when the normal cycle placed nothing."""
    nfound, nnode, ntier, ngm, ncm = vals[:NORMAL_FIELDS]
    if nfound:
        return FusedPlanResult("placed", nnode, Placement(
            gpu_mask=ngm & 0xFFFFFFFF, cg_mask=ncm & 0xFFFFFFFF,
            tier=ntier))
    out = shortlist_fn()
    _append_winner(out, vals[NORMAL_FIELDS:], sel, patches, ctx)
    for chunk_vals, chunk in wide_chunks_fn():
        _append_winner(out, chunk_vals, chunk, patches, ctx)
    if not out:
        return FusedPlanResult("rejected", n_candidates=out.n_candidates)
    chosen = select_best(out, alpha)
    return FusedPlanResult(
        "preempted", chosen.node,
        out.placements.get((chosen.node, chosen.victims)),
        chosen.victims, out.n_candidates)


def plan_fused(cluster, workload: WorkloadSpec, alpha: float = DEFAULT_ALPHA,
               allow_preempt: bool = True) -> FusedPlanResult:
    """BOTH cycles of Algorithm 1 (the engine hook for ``fused_place``).

    Three launches — the normal cycle, the sweep, the tail — and one
    readback decide the plan; wide rows re-dispatch afterwards and only
    when the normal cycle failed, and overflow rows fall back to host
    ``flextopo_imp``, as in `source_candidates_fused`.
    """
    if not allow_preempt:
        got = plan_normal_fused(cluster, workload)
        if got is None:
            return FusedPlanResult("rejected")
        return FusedPlanResult("placed", got[0], got[1])
    spec = cluster.spec
    dcs = _device_state(cluster)
    ctx = dcs.mirror
    req = _request(spec, workload, alpha)
    patches = _view_patches_of(cluster, dcs)
    p, pidx, pbuf = _patch_args(dcs, patches)
    split, pidx_d, pbuf_d, gidx_d = _fast_plan_args(dcs, patches,
                                                    workload.priority, p,
                                                    pidx, pbuf)
    vals = _plan2_pipeline(dcs, pidx_d, pbuf_d, gidx_d, req, spec,
                           split.m_res).tolist()     # the one readback
    n = dcs.n_rows
    sel = ({n + j: node for j, node in enumerate(split.mid)}
           if split.mid else None)

    def shortlist():
        out = CandidateShortlist(_overflow_candidates(cluster, workload,
                                                      split.overflow))
        out.n_candidates = len(out)
        return out

    def wide_chunks():
        return _chunked(dcs, pidx_d, pbuf_d, split.wide, req, spec, ctx.cap)

    return _finalize_plan(vals, sel, patches, ctx, shortlist, wide_chunks,
                          alpha)


def warmup_fused(cluster: Cluster, alpha: float = DEFAULT_ALPHA,
                 workloads=None) -> None:
    """Build the kernels and fill the caches before the first plan.

    Opt-in via ``TopoScheduler(..., warmup=True)``: drives real sourcing
    (pure reads against copy-on-write views, so cluster state is
    untouched) for each preemptor class, once against the clean state and
    once against a view with a delta, so the kernels' build, the resident
    upload and the routing caches are paid at construction instead of on
    the first plans.  ``workloads`` defaults to the Table 3 classes.
    """
    from .workload import table3_workloads

    workloads = list(table3_workloads() if workloads is None else workloads)
    cluster.device_state().sync()
    for wl in workloads:
        source_candidates_fused(cluster, wl, None, alpha=alpha)
        plan_fused(cluster, wl, alpha=alpha)
        plan_normal_fused(cluster, wl)
        view = cluster.view()
        for node in range(cluster.num_nodes):    # fabricate one view delta
            victims = view.victims_on(node, wl.priority)
            if victims:
                view.plan_evict(victims[0].uid)
                source_candidates_fused(view, wl, None, alpha=alpha)
                plan_fused(view, wl, alpha=alpha)
                plan_normal_fused(view, wl)
                break


register_engine("imp_batched", batched=True, needs_alpha=True,
                fused_filter=True, fused_place=True, plan_fn=plan_fused,
                normal_fn=plan_normal_fused,
                warmup_fn=warmup_fused)(source_candidates_fused)

# full-sweep parity oracle of the reference (where imp_batched also takes a
# shortlist); here the two registrations are the same functions
register_engine("imp_batched_full", batched=True, needs_alpha=True,
                fused_filter=True, fused_place=True, plan_fn=plan_fused,
                normal_fn=plan_normal_fused,
                warmup_fn=warmup_fused)(source_candidates_fused)
