"""The fused ``imp_batched`` engine: Algorithm 1 over the device-resident state.

Counterpart of the single-request, shortlist and batch-session paths of the
reference's ``repro.core.preemption_jax``.  One plan runs over the
cluster's `DeviceClusterState` (``Cluster.device_state``) as a chain of
kernel launches in stream order and ONE readback:

1. ``kernels.normal_cycle`` (K2, normal-cycle form): the normal cycle over
   every node — count screen, placement tier, blind tier, the exact
   ``(tier, leftover, node)`` argmin and the winner's masks;
2. ``kernels.fused_class.fused_class`` (K1, resident form): Guaranteed
   Filtering on the drain masks, the narrow gate, and every victim subset
   of every row, reduced to per-(row, tier) class winners;
3. ``kernels.fused_class.fused_argmax`` (K1's tail): the Eq. 2 argmax with
   its exact tie chain and the winner's placement.

Launches after the first read the normal cycle's ``found`` on the device
and return at once when it is set (the reference's ``lax.cond``).  A
copy-on-write `ClusterView`'s delta rows and the rows ``sync(flush=False)``
left pending ride the launches as patch rows: the view's rows are
described by a `ViewDelta` and rebuilt on the device by
``kernels.view_delta.encode_delta`` straight into the plan's patch buffer
(rows it cannot rebuild exactly are encoded on the host by ``encode_row``
and copied in by the same launch); the resident tensors are never written
by a plan.

**The shortlist** (``shortlist=ShortlistConfig``, above ``k`` rows):
``kernels.prescreen.prescreen`` bounds every row's Eq. 2 score from its
aggregates and keeps the top ``k`` class representatives
(`DeviceClusterState.rep_classes`, with the patched rows and the promoted
members of their old classes forced in, `_forced_rows`); the sweep and the
tail then run over those ``k`` rows only.  The readback holds the bound
left out, and the host checks that the winner's exact score beats it
strictly; in ``"guaranteed"`` mode a plan that cannot prove it runs the
full sweep (two more launches on the same patch tensors).

**Batch sessions** (`BatchSourcingSession`, ``plan_batch``): the resident
sweep once per distinct request of the batch against one snapshot; each
plan then merges its request's class data, with the view's delta rows
masked out, with a `NARROW_M`-wide sweep of the patched delta rows and the
untouched rows above the session's gate, behind the normal cycle.
Sessions persist across ``plan_batch`` calls until the cluster changes
(`persistent_batch_session`).

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

Every pipeline runs over the state's ``shards``: the unsharded state is its
own one shard, and a `cluster_parallel.ShardedDeviceClusterState` (the
``imp_sharded`` engine) has one a device of its mesh.  Over D > 1 shards
each kernel runs once a shard on that shard's rows (global row ids in the
patch and gathered indices) and the shards' records are merged: the last
shard's tail and K2 merge the earlier shards' records in their own launches
(``fused_argmax(prior=)``, ``normal_cycle(prior=)``), and
``prescreen.prescreen_select`` merges the shortlists; over one shard
nothing is merged.

**The per-size engines** ``imp_batched_legacy`` (one sweep per subset size
over every node, the reference's exact oracle for the fused path) and
``imp_jax`` (the same per node) fold each size's combination table into
freed masks with tensor ops and take the tier from K3
(``kernels.topo_score.topo_score``); selection stays on the host.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.fused_class import (C_ANY, C_CB, C_CNT, C_K, C_PP,
                                             C_UM, CLS_FIELDS, PART_FIELDS,
                                             WIN_FIELDS, FusedRequest,
                                             fused_argmax, fused_class)
from repro_torch.kernels.normal_cycle import (NORMAL_FIELDS, normal_cycle,
                                              normal_cycle_part, part_records)
from repro_torch.kernels.prescreen import prescreen, prescreen_select
from repro_torch.kernels.view_delta import encode_delta
from repro_torch.kernels.topo_score import TopoRequest, topo_score

from .cluster import (DD_POS, IDX_SENTINEL, MAX_DENSE_VICTIMS, Cluster,
                      DeviceClusterState, VictimRow, ViewDelta, _i32,
                      encode_row, flatten_rows, pack_context_rows, pack_rows,
                      pad_idx, row_width)
from .engines import register_engine
from .placement import Placement
from .scheduler import ShortlistConfig
from .scoring import DEFAULT_ALPHA, TIER_SCORES, Candidate, select_best
from .topology import ServerSpec
from .workload import TopoPolicy, WorkloadSpec

#: victim-slot width of the resident sweep; rows with more eligible victims
#: are gated out on the device and re-dispatched wide
NARROW_M = 8
#: smallest victim-slot width of the adaptive resident sweep
MIN_M = 4
#: rows per wide (16-slot, 65536-subset) chunk; each chunk has its own winner
MAX_ROWS_WIDE = 16
#: class-data fields a batch plan zeroes at the view's delta rows
_MASKED = (C_ANY, C_ANY + 1, C_ANY + 2, C_CNT)

__all__ = ["BatchSourcingSession", "CandidateShortlist", "ClassWinners",
           "FusedPlanResult", "FusedSplit", "IDX_SENTINEL", "MAX_ROWS_WIDE",
           "MIN_M", "NARROW_M", "PATH_COUNTS", "Request", "ShortlistConfig",
           "WIN_FIELDS", "cluster_victim_arrays", "combo_table",
           "evaluate_subsets",
           "expected_launches", "flextopo_imp_vectorized",
           "persistent_batch_session", "plan_fused", "plan_normal_fused",
           "source_candidates_batched", "source_candidates_fused",
           "split_dense_nodes", "split_fused_nodes", "warmup_fused"]

#: what the engine ran since the counters were last set to 0, recorded
#: where it decides, not where a kernel launches (``chip_smoke.py`` holds
#: the kernels' launch counts to them): each pipeline by name
#: (``plan2``: K2, the sweep, the tail; ``shortlist_plan2``: K2, the
#: prescreen, the sweep, the tail; ``shortlist``: the prescreen, the sweep,
#: the tail; ``sweep``: the sweep and the tail; ``normal``: K2; ``gathered``:
#: a gathered sweep and its tail; ``merge``/``merge_normal``: a batch
#: plan's gathered sweep and tail, behind K2 for the latter;
#: ``session_requests``: the sweeps that build a session's class data;
#: ``encoded``: the delta encoder's launches), and what the shortlist
#: decided: ``certain`` plans proved their winner, ``fallback`` plans
#: re-ran the full sweep; ``sessions`` built.  A pipeline over a sharded
#: state counts once a shard, and its merges count under ``tail_merges``,
#: ``normal_merges`` (each made inside the last shard's launch of the tail
#: or of K2) and ``unions``
PATH_COUNTS = dict.fromkeys((
    "plan2", "shortlist_plan2", "shortlist", "sweep", "normal", "gathered",
    "merge", "merge_normal", "session_requests", "encoded", "certain",
    "fallback", "sessions", "tail_merges", "normal_merges", "unions"), 0)


def expected_launches(counts: dict) -> dict[str, int]:
    """The launches of each fused kernel that the paths in ``counts`` (a
    `PATH_COUNTS` record) make on a CUDA device, and under ``tail_merge``
    and ``normal_merge`` how many of the tail's and K2's launches merge the
    earlier shards' records (their wrappers' ``merges``)."""
    c = counts
    tail = (c["plan2"] + c["shortlist_plan2"] + c["shortlist"] + c["sweep"]
            + c["gathered"] + c["merge"] + c["merge_normal"])
    return {"normal_cycle": (c["plan2"] + c["shortlist_plan2"] + c["normal"]
                             + c["merge_normal"]),
            "prescreen": c["shortlist_plan2"] + c["shortlist"],
            "fused_class": tail + c["session_requests"],
            "fused_argmax": tail,
            "encode_delta": c["encoded"],
            "tail_merge": c["tail_merges"],
            "normal_merge": c["normal_merges"],
            "prescreen_select": c["unions"]}


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
    r = Request.of(spec, workload)
    return r.need_gpus, r.need_cgs, r.cgs_per_bundle


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


# ---------------------------------------------------------------------------------
# The per-size engines: imp_batched_legacy and imp_jax, through K3
# ---------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def combo_table(m: int, k: int) -> np.ndarray:
    """int32[C(m, k), k]: every size-k index combination of range(m), in
    ``itertools.combinations`` order."""
    if k == 0:
        return np.zeros((1, 0), dtype=np.int32)
    return np.asarray(list(itertools.combinations(range(m), k)),
                      dtype=np.int32).reshape(-1, k)


@dataclasses.dataclass(frozen=True)
class Request:
    """A preemptor's resource ask (the reference's static request)."""

    need_gpus: int
    need_cgs: int
    bundle_locality: bool

    @property
    def cgs_per_bundle(self) -> int:
        if not self.need_gpus:
            return 0
        return self.need_cgs // self.need_gpus if self.bundle_locality else 0

    @classmethod
    def of(cls, spec: ServerSpec, workload: WorkloadSpec) -> "Request":
        return cls(workload.gpus_per_instance,
                   workload.coregroups_per_instance(spec.coregroup_size),
                   workload.numa_policy == TopoPolicy.GUARANTEED)


def evaluate_subsets(free_gpu, free_cg, victim_gpu, victim_cg, victim_prio,
                     victim_valid, table, *, spec: ServerSpec,
                     request: Request, alpha: float = DEFAULT_ALPHA):
    """Every subset in ``table`` (int32[n_comb, k] slot indices) at once,
    for one node (``free_*`` int32[], victim arrays [M]) or a leading node
    axis (int32[N] and [N, M]): ``(tier, prio_sum, valid, score)``, each
    ``[..., n_comb]``.

    The fold (the subset's masks ORed into the free masks, priorities
    summed as int32, validity ANDed) is tensor ops on the arrays' device;
    the tier and the Eq. 1 score come from K3 (`topo_score`) over the
    freed masks, one launch.  A subset that takes a padding slot
    (``victim_valid`` False) gets tier 3 and score -inf by an explicit
    mask: a padding slot's masks are 0, so K3 alone would score it as the
    smaller subset.  Counterpart of the reference's
    ``_evaluate_subsets_core`` (which returns no score)."""
    t = table.to(torch.int64)
    lead = free_gpu.shape
    n_comb = t.shape[0]
    combo_g = torch.zeros(lead + (n_comb,), dtype=torch.int32,
                          device=free_gpu.device)
    combo_c = torch.zeros_like(combo_g)
    prio = torch.zeros_like(combo_g)
    valid = torch.ones(combo_g.shape, dtype=torch.bool,
                       device=free_gpu.device)
    for j in range(t.shape[1]):       # k is small: an unrolled fold
        idx = t[:, j]
        combo_g |= victim_gpu[..., idx]
        combo_c |= victim_cg[..., idx]
        prio += victim_prio[..., idx]
        valid &= victim_valid[..., idx]
    freed_g = (free_gpu[..., None] | combo_g).reshape(-1)
    freed_c = (free_cg[..., None] | combo_c).reshape(-1)
    req = TopoRequest(request.need_gpus, request.need_cgs,
                      request.cgs_per_bundle, alpha)
    evaluate_subsets.calls += 1
    tier, score = topo_score(freed_g, freed_c, prio.reshape(-1), spec, req)
    tier = torch.where(valid, tier.view(combo_g.shape), 3)
    score = torch.where(valid, score.view(combo_g.shape), -np.inf)
    return tier, prio, valid, score


#: calls since the counter was last set to 0 (one K3 launch each on a CUDA
#: device, where the subsets are not none)
evaluate_subsets.calls = 0


def _bucket(m: int) -> int:
    """The victim-slot width of the padded arrays: 4, 8 or 16.  Nodes with
    more than `MAX_DENSE_VICTIMS` victims are split off first
    (`split_dense_nodes`)."""
    for b in (4, 8, 16):
        if m <= b:
            return b
    raise ValueError(f"too many victims on one node: {m}")


def split_dense_nodes(cluster, workload: WorkloadSpec, nodes: list[int]):
    """``(dense, overflow, per_node)``: the nodes whose potential victims
    fit the padded arrays, those with more than `MAX_DENSE_VICTIMS` (host
    ``flextopo_imp``), and every node's victim list."""
    per_node = {n: cluster.victims_on(n, workload.priority) for n in nodes}
    dense = [n for n in nodes if len(per_node[n]) <= MAX_DENSE_VICTIMS]
    overflow = [n for n in nodes if len(per_node[n]) > MAX_DENSE_VICTIMS]
    return dense, overflow, per_node


def cluster_victim_arrays(cluster, workload: WorkloadSpec, nodes: list[int],
                          per_node: dict | None = None):
    """Padded per-node arrays ``(free_gpu[N], free_cg[N], vg[N, M],
    vc[N, M], vp[N, M], valid[N, M], victims per node)`` as numpy, M the
    `_bucket` of the most victims on a node; ``per_node`` reuses
    `split_dense_nodes`' scan."""
    if per_node is not None:
        per_node = [per_node[n] for n in nodes]
    else:
        per_node = [cluster.victims_on(n, workload.priority) for n in nodes]
    m = _bucket(max((len(v) for v in per_node), default=1) or 1)
    n = len(nodes)
    free_gpu = np.zeros(n, np.int32)
    free_cg = np.zeros(n, np.int32)
    vg = np.zeros((n, m), np.int32)
    vc = np.zeros((n, m), np.int32)
    vp = np.zeros((n, m), np.int32)
    valid = np.zeros((n, m), bool)
    for i, node in enumerate(nodes):
        fg, fc = cluster.free_masks(node)
        free_gpu[i], free_cg[i] = _i32(fg), _i32(fc)
        for j, v in enumerate(per_node[i]):
            vg[i, j], vc[i, j] = _i32(v.gpu_mask), _i32(v.cg_mask)
            vp[i, j] = v.priority
            valid[i, j] = True
    return free_gpu, free_cg, vg, vc, vp, valid, per_node


@functools.lru_cache(maxsize=256)
def _table_on(device: str, m: int, k: int) -> torch.Tensor:
    return torch.from_numpy(combo_table(m, k)).to(device)


def _arrays_on(device, free_gpu, free_cg, vg, vc, vp, valid):
    """The arrays on ``device`` in one upload: ``(free_gpu, free_cg, vg,
    vc, vp, valid)`` tensors."""
    n, m = vg.shape
    up = torch.from_numpy(np.concatenate([
        np.atleast_1d(free_gpu), np.atleast_1d(free_cg), vg.ravel(),
        vc.ravel(), vp.ravel(), valid.ravel().astype(np.int32)]).astype(
            np.int32)).to(device)
    lead = np.shape(free_gpu)
    f = int(np.prod(lead, dtype=np.int64))
    nm = n * m
    return (up[0:f].view(lead), up[f:2 * f].view(lead),
            up[2 * f:2 * f + nm].view(vg.shape),
            up[2 * f + nm:2 * f + 2 * nm].view(vg.shape),
            up[2 * f + 2 * nm:2 * f + 3 * nm].view(vg.shape),
            up[2 * f + 3 * nm:].view(vg.shape) != 0)


def source_candidates_batched(cluster, workload: WorkloadSpec,
                              nodes: list[int]) -> list[Candidate]:
    """Cluster-wide IMP, one sweep per subset size k over every node (the
    ``imp_batched_legacy`` engine, the reference's exact oracle of the
    fused path): a node contributes candidates only at ITS smallest
    feasible k (done flags on the host), from the cluster-wide counting
    lower bound (`preemption.min_feasible_k`) until every node is done.
    One K3 launch and one readback a size; selection stays on the host
    (f64 ``select_best``).  Nodes with more than `MAX_DENSE_VICTIMS`
    victims go to host ``flextopo_imp``."""
    from .preemption import min_feasible_k

    spec = cluster.spec
    request = Request.of(spec, workload)
    nodes, overflow, by_node = split_dense_nodes(cluster, workload, nodes)
    extra = _overflow_candidates(cluster, workload, overflow)
    if not nodes:
        return extra
    free_gpu, free_cg, vg, vc, vp, valid, per_node = cluster_victim_arrays(
        cluster, workload, nodes, per_node=by_node)
    m = vg.shape[1]
    dev = cluster.device
    arrays = _arrays_on(dev, free_gpu, free_cg, vg, vc, vp, valid)
    done = np.zeros(len(nodes), bool)
    out: list[Candidate] = []
    start_k = min((min_feasible_k(cluster, workload, n, per_node[i])
                   for i, n in enumerate(nodes)), default=0)
    for k in range(start_k, m + 1):
        if done.all():
            break
        table = combo_table(m, k)
        tier, prio, _, _ = evaluate_subsets(
            *arrays, _table_on(str(dev), m, k), spec=spec, request=request)
        got = torch.stack([tier, prio]).cpu().numpy()
        tier, prio = got[0], got[1]
        for i, node in enumerate(nodes):
            if done[i] or k > len(per_node[i]):
                done[i] = done[i] or k > len(per_node[i])
                continue
            feasible = np.nonzero(tier[i] < 3)[0]
            if feasible.size:
                done[i] = True
                for idx in feasible:
                    out.append(Candidate(
                        node=node,
                        victims=tuple(sorted(
                            per_node[i][j].uid for j in table[idx])),
                        tier=int(tier[i, idx]),
                        priority_sum=int(prio[i, idx])))
    return out + extra


def flextopo_imp_vectorized(cluster, workload: WorkloadSpec,
                            node: int) -> list[Candidate]:
    """IMP on one node with each subset size's sweep vectorized (the
    ``imp_jax`` engine): sizes 0, 1, ... up to the first feasible one, one
    K3 launch and one readback a size; the same candidates as host
    ``flextopo_imp``."""
    spec = cluster.spec
    request = Request.of(spec, workload)
    victims = cluster.victims_on(node, workload.priority)
    m = len(victims)
    fg, fc = cluster.free_masks(node)
    vg = np.array([[_i32(v.gpu_mask) for v in victims] or [0]], np.int32)
    vc = np.array([[_i32(v.cg_mask) for v in victims] or [0]], np.int32)
    vp = np.array([[v.priority for v in victims] or [0]], np.int32)
    valid = np.array([[True] * m or [False]])
    dev = cluster.device
    free_g, free_c, vg_d, vc_d, vp_d, valid_d = _arrays_on(
        dev, np.int32(_i32(fg)), np.int32(_i32(fc)), vg, vc, vp, valid)
    for k in range(0, m + 1):
        table = combo_table(max(m, 1), k)
        tier, prio, _, _ = evaluate_subsets(
            free_g, free_c, vg_d[0], vc_d[0], vp_d[0], valid_d[0],
            _table_on(str(dev), max(m, 1), k), spec=spec, request=request)
        got = torch.stack([tier, prio]).cpu().numpy()
        feasible = np.nonzero(got[0] < 3)[0]
        if feasible.size:
            return [Candidate(node=node,
                              victims=tuple(sorted(victims[j].uid
                                                   for j in table[i])),
                              tier=int(got[0, i]),
                              priority_sum=int(got[1, i]))
                    for i in feasible]
    return []


register_engine("imp_batched_legacy", batched=True)(source_candidates_batched)
register_engine("imp_jax")(flextopo_imp_vectorized)


def _pad_idx(ids, floor: int = 4) -> np.ndarray:
    """`cluster.pad_idx` with the dispatch paths' minimum bucket of 4."""
    return pad_idx(ids, floor)


def _pack_patches(patches: dict[int, VictimRow], cap: int):
    """View-delta rows as ``(p, pidx, pbuf)``: node ids ascending, one
    flattened int32 buffer, both padded to a power of two (`_pad_idx`) with
    `IDX_SENTINEL` rows last; ``p`` = 0 without patches."""
    return _patch_rows(patches, None, (), cap)


def _host_rows(rows: dict[int, VictimRow], ctx, pending, cap: int):
    """``(ids, int32[len(ids), row_width])``: the host-encoded ``rows``
    (ascending) and then the mirror's ``pending`` rows."""
    ids, bufs = [], []
    if rows:
        nodes = sorted(rows)
        ids.extend(nodes)
        bufs.append(flatten_rows(*pack_rows([rows[n] for n in nodes], nodes,
                                            cap)))
    if pending:
        ids.extend(pending)
        bufs.append(flatten_rows(*pack_context_rows(ctx, pending)))
    if not bufs:
        return ids, np.zeros((0, row_width(cap)), np.int32)
    return ids, (np.concatenate(bufs) if len(bufs) > 1 else bufs[0])


def _patch_rows(rows: dict[int, VictimRow], ctx, pending, cap: int):
    width = row_width(cap)
    ids, buf = _host_rows(rows, ctx, pending, cap)
    if not ids:
        return 0, np.zeros(0, np.int32), np.zeros((0, width), np.int32)
    order = np.argsort(np.asarray(ids, np.int64), kind="stable")
    idx = _pad_idx(np.asarray(ids, np.int32)[order])
    pbuf = np.zeros((len(idx), width), np.int32)
    pbuf[:len(ids)] = buf[order]
    return len(idx), idx, pbuf


def _patch_row(patches, node: int) -> VictimRow:
    """Exact host row for one delta node (`ViewDelta` encodes lazily)."""
    if isinstance(patches, ViewDelta):
        return patches.row(node)
    return patches[node]


def _patch_elig(patches, thresh: int):
    """``(eligible-count, truncation-risk)`` dicts over the delta nodes:
    from a `ViewDelta`'s descriptor metadata (no host encode of its dense
    rows), or row by row from a ``{node: VictimRow}`` dict."""
    if isinstance(patches, ViewDelta):
        return patches.elig_bad(thresh)
    return ({n: int(((r.vp < thresh) & r.stored).sum())
             for n, r in patches.items()},
            {n: bool(r.overflow and r.next_priority < thresh)
             for n, r in patches.items()})


class _Staged(NamedTuple):
    """A plan's patch rows on the state's device: ``p`` rows (a power of
    two, `IDX_SENTINEL` pads last), their ascending index ``pidx`` (host
    copy ``pidx_host``) and flattened rows ``pbuf``, and the ``tail`` index
    vector that rode the same upload (gathered or forced rows).  Over D > 1
    shards ``pidx``, ``pbuf`` and ``tail`` are lists, one a shard on its
    device: its run of the patch rows (global row ids) and all of ``tail``
    (`_each`)."""

    p: int
    pidx_host: np.ndarray
    pidx: torch.Tensor
    pbuf: torch.Tensor
    tail: torch.Tensor


def _patch_plan(dcs: DeviceClusterState, patches, pending: bool = True):
    """The host side of a plan's patch rows — the view's delta rows
    (``patches``, a `ViewDelta` or a ``{node: VictimRow}`` dict) and, with
    ``pending``, the state's unflushed rows: ``(pidx, desc, adds, hpos,
    hbuf)``.  ``pidx`` is the ascending patch index padded with
    `IDX_SENTINEL` to a power of two; ``desc``/``adds`` the `ViewDelta`'s
    dense-row descriptors with each row's place in it (None without dense
    rows); ``hbuf`` the host-encoded rows (fallback, then pending) and
    ``hpos`` their places."""
    cap = dcs.cap
    if isinstance(patches, ViewDelta):
        dense, host = patches.dense, patches.fallback
    else:
        dense, host = np.zeros(0, np.int32), patches
    left = sorted(set(dcs.pending) - set(patches)) if pending else []
    hids, hbuf = _host_rows(host, dcs.mirror, left, cap)
    ids = np.concatenate([dense, np.asarray(hids, np.int32)]).astype(
        np.int64)
    if not len(ids):
        return np.zeros(0, np.int32), None, None, np.zeros(0, np.int32), hbuf
    order = np.argsort(ids, kind="stable")
    pidx = _pad_idx(ids[order].astype(np.int32))
    pos = np.empty(len(ids), np.int32)
    pos[order] = np.arange(len(ids), dtype=np.int32)
    d = len(dense)
    desc = adds = None
    if d:
        desc, adds = patches.descriptors(pos[:d])
    return pidx, desc, adds, pos[d:], hbuf


def _each(x) -> list:
    """A per-shard argument as a list: a bare tensor is a one-shard
    state's."""
    return x if isinstance(x, list) else [x]


def _one(xs: list):
    """Per-shard tensors as the pipelines' argument: the tensor itself for
    one shard, else the list."""
    return xs[0] if len(xs) == 1 else xs


def _on(x: torch.Tensor | None, device: torch.device):
    return x if x is None or x.device == device else x.to(device)


def _by_device(dcs: DeviceClusterState, arrays: list[np.ndarray]) -> list:
    """Shard ``d``'s int32 array ``arrays[d]`` on its device, in one upload
    a device (the shards on one device share it, as views)."""
    shards = dcs.shards
    out: list = [None] * len(arrays)
    for dev in dict.fromkeys(s.device for s in shards):
        ids = [d for d, s in enumerate(shards) if s.device == dev]
        flat = [np.ascontiguousarray(arrays[d], np.int32).ravel() for d in ids]
        up = torch.from_numpy(flat[0] if len(flat) == 1
                              else np.concatenate(flat)).to(dev)
        o = 0
        for d in ids:
            out[d] = up[o:o + arrays[d].size].view(arrays[d].shape)
            o += arrays[d].size
    return out


def _stage(dcs: DeviceClusterState, patches, tail=None,
           pending: bool = True) -> _Staged:
    """The patch rows of a plan (`_patch_plan`) plus the index vector
    ``tail``, in ONE host→device upload a device.  A `ViewDelta`'s dense
    rows travel as descriptors and one ``encode_delta`` launch a shard
    writes each row to its place in the patch buffer; without dense rows
    the buffer travels packed.  Each shard takes its run of the sorted
    patch index (the `IDX_SENTINEL` pads in the last) and rebuilds its
    dense rows from its own rows."""
    if not len(patches) and not (pending and dcs.pending) and tail is None:
        pidx_d, pbuf_d = _empty_patch_args(dcs)
        return _Staged(0, np.zeros(0, np.int32), pidx_d, pbuf_d, pidx_d)
    width = row_width(dcs.cap)
    tail = np.zeros(0, np.int32) if tail is None else np.asarray(tail,
                                                                 np.int32)
    nt = len(tail)
    pidx, desc, adds, hpos, hbuf = _patch_plan(dcs, patches, pending)
    p = len(pidx)
    if p == 0:
        pidx_d, pbuf_d = _empty_patch_args(dcs)
        return _Staged(0, pidx, pidx_d, pbuf_d,
                       _upload(dcs, tail) if nt else pidx_d)
    shards = dcs.shards
    cut = [0, *np.searchsorted(pidx, [s.base for s in shards[1:]]), p]
    arrays, jobs = [], []
    for lo, hi in zip(cut, cut[1:]):
        h = (hpos >= lo) & (hpos < hi)
        parts = [pidx[lo:hi], tail]
        mine = (None if desc is None
                else (desc[DD_POS] >= lo) & (desc[DD_POS] < hi))
        if mine is not None and mine.any():
            dd, aa = desc[:, mine], adds[:, mine]
            dd[DD_POS] -= lo
            parts += [dd, aa, hpos[h] - lo, hbuf[h]]
            jobs.append((dd.shape, aa.shape, int(h.sum())))
        else:
            pbuf = np.zeros((hi - lo, width), np.int32)
            pbuf[hpos[h] - lo] = hbuf[h]
            parts.append(pbuf)
            jobs.append(None)
        arrays.append(np.concatenate([x.ravel() for x in parts]))
    pidx_l, pbuf_l, tail_l = [], [], []
    for d, (s, up) in enumerate(zip(shards, _by_device(dcs, arrays))):
        n_p = int(cut[d + 1] - cut[d])
        pidx_l.append(up[:n_p])
        tail_l.append(up[n_p:n_p + nt])
        o = n_p + nt
        if jobs[d] is None:
            pbuf_l.append(up[o:].view(n_p, width))
            continue
        ds, as_, nh = jobs[d]
        dd = up[o:o + ds[0] * ds[1]].view(ds)
        o += dd.numel()
        aa = up[o:o + as_[0] * as_[1] * as_[2]].view(as_)
        o += aa.numel()
        pbuf_l.append(encode_delta(s.nodestate, s.victims, dd, aa,
                                   up[o:o + nh], up[o + nh:].view(nh, width),
                                   p=n_p, base=s.base))
        PATH_COUNTS["encoded"] += 1
    return _Staged(p, pidx, _one(pidx_l), _one(pbuf_l), _one(tail_l))


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


def split_fused_nodes(dcs: DeviceClusterState, patches, thresh: int,
                      nodes=None, gate: int | None = None) -> FusedSplit:
    """Route rows between the main sweep and its re-dispatch tiers.

    Eligible victims are a prefix of each (priority, uid)-sorted row, so
    every row is classified by one vectorized count over the host mirror
    (patched rows overridden).  ``gate`` pins the main sweep's width (the
    shortlist's and the batch session's); when None it adapts.  When no
    node stores more than `MIN_M` victims (``dcs.count_max``) the scan is
    skipped.
    """
    ctx = dcs.mirror
    if isinstance(patches, ViewDelta):
        patch_big = [n for n in patches if patches.count(n) > MIN_M]
    else:
        patch_big = [n for n, r in patches.items() if r.count > MIN_M]
    if dcs.count_max <= MIN_M and not patch_big:
        return FusedSplit(MIN_M, [], [], [])
    n = dcs.cluster.num_nodes
    elig = ((ctx.vp < thresh) & ctx.stored).sum(axis=1)
    bad = ctx.overflow & (ctx.next_prio < thresh)
    p_elig, p_bad = _patch_elig(patches, thresh)
    for node, e in p_elig.items():
        elig[node] = e
    for node, b in p_bad.items():
        bad[node] = b
    if nodes is None:
        allowed = np.ones(n, bool)
    else:
        allowed = np.zeros(n, bool)
        allowed[list(nodes)] = True
    ok = allowed & ~bad
    m_res = gate
    if m_res is None:
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
        node = int(sel_nodes.get(row, row))   # resident + gathered rows
    else:
        node = int(sel_nodes[row])            # gathered chunk
    vu = _patch_row(patches, node).vu if node in patches else ctx.vu[node]
    uids = [int(vu[j]) for j in range(len(vu)) if (combo >> j) & 1]
    victims = tuple(sorted(uids))
    out.append(Candidate(node=node, victims=victims, tier=tier,
                         priority_sum=prio))
    out.placements[(node, victims)] = Placement(
        gpu_mask=pgm & 0xFFFFFFFF, cg_mask=pcm & 0xFFFFFFFF, tier=tier)


def _upload(dcs: DeviceClusterState, x: np.ndarray):
    """``x`` as int32 on the state's device (over D > 1 shards a list, the
    copy on each shard's device)."""
    x = np.ascontiguousarray(x, np.int32)
    on = {dev: torch.from_numpy(x).to(dev)
          for dev in dict.fromkeys(s.device for s in dcs.shards)}
    return _one([on[s.device] for s in dcs.shards])


def _empty_patch_args(dcs: DeviceClusterState):
    """Zero-row patch tensors on the state's device(s), made once."""
    got = dcs.plan_cache.get("empty")
    if got is None:
        got = dcs.plan_cache["empty"] = (
            _upload(dcs, np.zeros(0, np.int32)),
            _upload(dcs, np.zeros((0, row_width(dcs.cap)), np.int32)))
    return got


def _fast_plan_args(dcs: DeviceClusterState, patches, thresh: int):
    """Routing split + the staged patch rows of a ``nodes=None`` plan, the
    mid rows as the tail: ``(split, staged)``.  The patch-free case is
    cached per preemptor priority on the `DeviceClusterState`, keyed by
    its invalidation ``version``: repeated plans against unchanged state
    skip the host eligibility scan and the upload."""
    clean = not len(patches) and not dcs.pending
    cached = dcs.plan_cache.get(thresh) if clean else None
    if cached is not None and cached[0] == dcs.version:
        return cached[1:]
    split = split_fused_nodes(dcs, patches, thresh)
    gidx = _pad_idx(split.mid) if split.mid else None
    staged = _stage(dcs, patches, gidx)
    if clean:
        dcs.plan_cache[thresh] = (dcs.version, split, staged)
    return split, staged


def _full_args(dcs: DeviceClusterState, patches, thresh: int,
               staged: _Staged):
    """`_fast_plan_args` for the full sweep that follows an uncertain
    shortlist, on the patch tensors already staged: only the mid rows'
    index travels."""
    if staged.p == 0:
        return _fast_plan_args(dcs, patches, thresh)
    split = split_fused_nodes(dcs, patches, thresh)
    gidx = (_upload(dcs, _pad_idx(split.mid)) if split.mid
            else _empty_patch_args(dcs)[0])
    return split, staged._replace(tail=gidx)


def _forced_rows(dcs: DeviceClusterState, patches) -> list[int]:
    """Representative-mask corrections for the view's delta rows.

    The rep mask comes from the MIRROR's fingerprints, but a patched row
    is read with other content, so (a) every patched row is taken as its
    own (possibly new) class, and (b) where a patched row represented its
    old class, the lowest unpatched member of that class is promoted.
    Extra representatives only add rows to the prescreen; a MISSING one
    could hide the argmax, and these two corrections close the ways one
    can go missing.  Pending rows need nothing: their mirror fingerprints
    are fresh."""
    pset = {int(n) for n in patches} if patches else set()
    if not pset:
        return []
    fp = dcs.mirror.fp
    forced = set(pset)
    for d in pset:
        for mbr in np.nonzero(fp == fp[d])[0]:
            if int(mbr) not in pset:
                forced.add(int(mbr))
                break
    return sorted(forced)


def _shortlist_plan_args(dcs: DeviceClusterState, patches, thresh: int):
    """`_fast_plan_args`'s shortlist twin: the wide/overflow split at gate
    `NARROW_M` (the second stage sweeps `NARROW_M` wide, so only truly wide
    and overflow rows route out) and the staged patch rows with the forced
    representatives as the tail, cached per preemptor priority while the
    state version holds."""
    clean = not len(patches) and not dcs.pending
    key = ("shortlist", thresh)
    cached = dcs.plan_cache.get(key) if clean else None
    if cached is not None and cached[0] == dcs.version:
        return cached[1:]
    split = split_fused_nodes(dcs, patches, thresh, gate=NARROW_M)
    forced = _forced_rows(dcs, patches)
    staged = _stage(dcs, patches, _pad_idx(forced) if forced else None)
    if clean:
        dcs.plan_cache[key] = (dcs.version, split, staged)
    return split, staged


# ---------------------------------------------------------------------------------
# The pipelines: chains of kernel launches, no host round trip inside
# ---------------------------------------------------------------------------------

def _sweep_tail(shards, pidx, pbuf, gidx, req: FusedRequest, spec, *,
                m_res: int, resident: bool, m_gather: int,
                seg: int | None = None, skip=None, out=None,
                cls=None) -> torch.Tensor:
    """Filtering → the class sweep at width ``m_res`` (or the given class
    data ``cls``) → the Eq. 2 argmax → the winner's placement, over the
    rows of ``shards``: int32[segments, `WIN_FIELDS`].  Resident: one
    segment, the resident rows and then the gathered `m_gather`-wide rows
    ``gidx``; gathered only: segments of ``seg`` rows of ``gidx``.  Over
    D > 1 shards each earlier shard's tail writes its exact monoid state
    (flat indices of global rows) into a buffer on the last shard's device,
    and the last shard's tail merges them in its own launch, so the tie
    chain's same-tier test is global."""
    pidx, pbuf, gidx = _each(pidx), _each(pbuf), _each(gidx)

    def sweep(d, s, sk):
        if cls is not None:
            return _each(cls)[d]
        return fused_class(s.nodestate, s.victims, s.drain, pidx[d], pbuf[d],
                           gidx[d], m_res=m_res, resident=resident,
                           m_gather=m_gather, req=req, spec=spec, skip=sk,
                           base=s.base)

    if len(shards) == 1:
        s = shards[0]
        c = sweep(0, s, skip)
        return fused_argmax(c, s.nodestate, s.victims, pidx[0], pbuf[0],
                            gidx[0], resident=resident,
                            seg=c.shape[1] if resident else seg, req=req,
                            spec=spec, skip=skip, out=out)
    *earlier, last = shards
    rows, n_rows = last.rows, last.rows * len(shards)
    g = gidx[0].shape[0]
    segs = 1 if resident else -(-g // seg)
    prior = torch.empty((len(earlier), segs, PART_FIELDS), dtype=torch.int32,
                        device=last.device)

    def tail(d, s, out, prior=None):
        sk = _on(skip, s.device)
        return fused_argmax(sweep(d, s, sk), s.nodestate, s.victims, pidx[d],
                            pbuf[d], gidx[d], resident=resident,
                            seg=rows + g if resident else seg, req=req,
                            spec=spec, skip=sk, out=out, base=s.base,
                            shard=((rows, s.base, n_rows - rows) if resident
                                   else (0, 0, 0)), prior=prior)

    for d, s in enumerate(earlier):
        rec = prior[d] if s.device == last.device else None
        got = tail(d, s, rec)
        if rec is None:
            prior[d].copy_(got)
    PATH_COUNTS["tail_merges"] += 1
    return _into(out, lambda o: tail(len(earlier), last, o, prior),
                 last.device, shards[0].device)


def _into(out, call, device: torch.device, home: torch.device):
    """``call(o)``'s result on ``device``, written into ``out`` when given
    (``o`` is ``out`` where it lies on ``device``, else None and the result
    is copied in); without ``out``, moved to ``home``, the mesh's first
    device, where the readback lives."""
    if out is None:
        return _on(call(None), home)
    if out.device == device:
        return call(out)
    out.copy_(call(None).view(out.shape))
    return out


def _normal(shards, pidx, pbuf, req: FusedRequest, spec,
            out=None) -> torch.Tensor:
    """The normal cycle over the rows of ``shards``: int32[5].  Over D > 1
    shards each earlier shard's K2 writes its minima and its row 0
    (`normal_cycle_part`) into a buffer on the last shard's device, and
    the last shard's K2 merges them in its own launch and places the
    least."""
    pidx, pbuf = _each(pidx), _each(pbuf)
    if len(shards) == 1:
        s = shards[0]
        return normal_cycle(s.nodestate, s.victims, s.drain, pidx[0],
                            pbuf[0], req=req, spec=spec, out=out)
    *earlier, last = shards
    prior = torch.empty((len(earlier), part_records(last.rows, last.device),
                         4), dtype=torch.int32, device=last.device)
    for d, s in enumerate(earlier):
        rec = prior[d] if s.device == last.device else None
        got = normal_cycle_part(s.nodestate, s.victims, s.drain, pidx[d],
                                pbuf[d], req=req, spec=spec, base=s.base,
                                out=rec)
        if rec is None:
            prior[d].copy_(got)
    PATH_COUNTS["normal_merges"] += 1
    return _into(out, lambda o: normal_cycle(
        last.nodestate, last.victims, last.drain, pidx[-1], pbuf[-1],
        req=req, spec=spec, base=last.base, prior=prior, out=o),
        last.device, shards[0].device)


def _plan_pipeline(dcs, pidx, pbuf, gidx, req, spec, m) -> torch.Tensor:
    """The preemption phase alone: two launches a shard,
    int32[`WIN_FIELDS`]."""
    PATH_COUNTS["sweep"] += len(dcs.shards)
    return _sweep_tail(dcs.shards, pidx, pbuf, gidx, req, spec, m_res=m,
                       resident=True, m_gather=NARROW_M)[0]


def _plan2_pipeline(dcs, pidx, pbuf, gidx, req, spec, m) -> torch.Tensor:
    """BOTH cycles of Algorithm 1: the normal cycle writes out[:5]; the
    sweep and its tail read out[0] on the device and return at once when
    it is set.  Returns int32[5 + `WIN_FIELDS`]."""
    PATH_COUNTS["plan2"] += len(dcs.shards)
    out = torch.empty(NORMAL_FIELDS + WIN_FIELDS, dtype=torch.int32,
                      device=dcs.device)
    _normal(dcs.shards, pidx, pbuf, req, spec, out=out[:NORMAL_FIELDS])
    _sweep_tail(dcs.shards, pidx, pbuf, gidx, req, spec, m_res=m,
                resident=True, m_gather=NARROW_M, skip=out[:1],
                out=out[NORMAL_FIELDS:])
    return out


def _normal_pipeline(dcs, pidx, pbuf, req, spec) -> torch.Tensor:
    """The normal cycle alone: one launch a shard, int32[5]."""
    PATH_COUNTS["normal"] += len(dcs.shards)
    return _normal(dcs.shards, pidx, pbuf, req, spec)


class _ShortlistOut(NamedTuple):
    """A shortlisted plan's readback buffer, int32[5 + `WIN_FIELDS` + k +
    1] (the normal cycle, the winner, ``gidx``, ``excl_ub``), and its
    views.  One per state and ``k``, reused plan after plan (each plan
    reads it back before the next is launched): the sweep and the tail
    then see the same ``gidx`` tensor every plan, so their checked launch
    states are kept (`fused_class.launch_state`)."""

    out: torch.Tensor
    normal: torch.Tensor
    skip: torch.Tensor
    tail: torch.Tensor      # the winner onwards: _shortlist_winner's result
    win: torch.Tensor
    sl: torch.Tensor
    gidx: torch.Tensor


def _shortlist_out(dcs: DeviceClusterState, k: int) -> _ShortlistOut:
    got = dcs.plan_cache.get(("shortlist_out", k))
    if got is None:
        out = torch.empty(NORMAL_FIELDS + WIN_FIELDS + k + 1,
                          dtype=torch.int32, device=dcs.device)
        tail = out[NORMAL_FIELDS:]
        got = dcs.plan_cache[("shortlist_out", k)] = _ShortlistOut(
            out, out[:NORMAL_FIELDS], out[:1], tail, tail[:WIN_FIELDS],
            tail[WIN_FIELDS:], tail[WIN_FIELDS:WIN_FIELDS + k])
    return got


def _shortlist_winner(dcs, staged: _Staged, rep, req, spec, k: int,
                      skip=None) -> torch.Tensor:
    """Stage 1 (the prescreen) → the exact sweep and tail over its ``k``
    rows: int32[`WIN_FIELDS` + k + 1], the winner (its row indexes
    ``gidx``), then ``gidx`` and the bits of ``excl_ub`` (a view of the
    state's `_ShortlistOut`).  Over D > 1 shards each shard's prescreen
    keeps its top min(k, rows) keys by ``(bound, -global row)``, which are
    unique, and `prescreen_select` takes the top k of their union; each
    shard then sweeps the rows of ``gidx`` it holds."""
    shards = dcs.shards
    if skip is None:
        PATH_COUNTS["shortlist"] += len(shards)
    buf = _shortlist_out(dcs, k)
    pidx, pbuf, tail, rep = (_each(x) for x in (staged.pidx, staged.pbuf,
                                                staged.tail, rep))
    if len(shards) == 1:
        s = shards[0]
        prescreen(s.nodestate, s.victims, pidx[0], pbuf[0], rep[0], tail[0],
                  k=k, req=req, spec=spec, skip=skip, out=buf.sl)
        gidx = buf.gidx
    else:
        dev0 = shards[0].device
        kd = min(k, shards[0].rows)
        keys = torch.empty((len(shards), kd), dtype=torch.int64, device=dev0)
        souts = torch.empty((len(shards), kd + 1), dtype=torch.int32,
                            device=dev0)
        for d, s in enumerate(shards):
            same = s.device == dev0
            sel = keys[d] if same else torch.empty(kd, dtype=torch.int64,
                                                   device=s.device)
            o = prescreen(s.nodestate, s.victims, pidx[d], pbuf[d], rep[d],
                          tail[d], k=kd, req=req, spec=spec,
                          skip=_on(skip, s.device),
                          out=souts[d] if same else None, base=s.base,
                          sel=sel)
            if not same:
                souts[d].copy_(o)
                keys[d].copy_(sel)
        PATH_COUNTS["unions"] += 1
        prescreen_select(keys, k=k, excl=souts[:, kd], skip=skip, out=buf.sl)
        gidx = [_on(buf.gidx, s.device) for s in shards]
    _sweep_tail(shards, pidx, pbuf, gidx, req, spec, m_res=NARROW_M,
                resident=False, m_gather=NARROW_M, seg=k, skip=skip,
                out=buf.win)
    return buf.tail


def _shortlist_plan2_pipeline(dcs, staged: _Staged, rep, req, spec,
                              k: int) -> torch.Tensor:
    """The shortlisted chained plan: the normal cycle, then
    `_shortlist_winner` behind its ``found``.  Returns int32[5 +
    `WIN_FIELDS` + k + 1]."""
    PATH_COUNTS["shortlist_plan2"] += len(dcs.shards)
    buf = _shortlist_out(dcs, k)
    _normal(dcs.shards, staged.pidx, staged.pbuf, req, spec, out=buf.normal)
    _shortlist_winner(dcs, staged, rep, req, spec, k, skip=buf.skip)
    return buf.out


def _eq1(pp: int, tier: int, alpha: float) -> np.float32:
    """The Eq. 1 score in f32, one rounding an operation (the kernels'
    and `kernels.fused_class._scores`' rule)."""
    one = np.float32(1.0)
    term = one / np.float32(max(pp, 1)) if pp > 0 else one
    return (np.float32(alpha) * term
            + np.float32(1.0 - alpha) * np.float32(TIER_SCORES[tier]))


def _shortlist_decode(vals, k: int, alpha: float):
    """``(win, sel, certain)`` of a shortlist readback ``vals``
    (int32[`WIN_FIELDS` + k + 1] as host ints): the winner, its row →
    real node id, and the certainty bit — the winner's exact score beats
    every excluded row's bound strictly, or there is no winner and
    nothing was excluded."""
    win = vals[:WIN_FIELDS]
    gidx = vals[WIN_FIELDS:WIN_FIELDS + k]
    excl = np.array([vals[WIN_FIELDS + k]], np.int32).view(np.float32)[0]
    if win[0]:
        certain = bool(_eq1(win[4], win[2], alpha) > excl)
        sel = {win[1]: gidx[win[1]]}
    else:
        certain = bool(excl == -np.inf)
        sel = None
    return win, sel, certain


def _gathered_pipeline(dcs, pidx, pbuf, gidx, req, spec, m: int,
                       seg: int) -> torch.Tensor:
    """The rows named by ``gidx`` (no resident section, no gate) at width
    ``m``, one winner per segment of ``seg`` rows: int32[segs,
    `WIN_FIELDS`].  `IDX_SENTINEL` entries are zero rows that never win
    (over D > 1 shards, so is a row another shard holds)."""
    PATH_COUNTS["gathered"] += len(dcs.shards)
    return _sweep_tail(dcs.shards, pidx, pbuf, gidx, req, spec, m_res=m,
                       resident=False, m_gather=m, seg=seg)


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

def _view_patches_of(cluster, dcs: DeviceClusterState):
    """The delta rows of a `ClusterView` as a `ViewDelta` (its dense rows
    rebuilt on the device by the delta encoder); ``{}`` for the base
    cluster."""
    if not (getattr(cluster, "_evicted", None)
            or getattr(cluster, "_added", None)):
        return {}       # the base cluster, or a view with no planned change
    return ViewDelta(cluster, dcs.mirror, dcs.pending)


def _device_state(cluster) -> DeviceClusterState:
    base = getattr(cluster, "base", cluster)
    # flush=False: small dirty sets stay pending and ride the launches as
    # patch rows instead of paying a standalone scatter
    return base.device_state().sync(flush=False)


def _shortlisted(dcs, shortlist: ShortlistConfig | None) -> bool:
    return shortlist is not None and dcs.n_rows > shortlist.k


def _mid_sel(dcs, split: FusedSplit):
    """Row → node of a full sweep's gathered mid rows (after the N
    resident rows), or None."""
    n = dcs.n_rows
    return ({n + j: node for j, node in enumerate(split.mid)}
            if split.mid else None)


def source_candidates_fused(cluster, workload: WorkloadSpec,
                            nodes: list[int] | None = None,
                            alpha: float = DEFAULT_ALPHA,
                            shortlist: ShortlistConfig | None = None
                            ) -> CandidateShortlist:
    """Fused cluster-wide IMP over the device-resident state.

    ``nodes=None`` (the scheduler's ``fused_filter`` path) runs Guaranteed
    Filtering, the subset sweep and the Eq. 2 argmax over ALL rows: the
    resident sweep and its tail (two launches), then the wide chunks; with
    a ``shortlist`` (and more rows than its ``k``) the prescreen and the
    sweep over its rows instead, the full sweep only where guaranteed mode
    cannot prove the shortlist's winner.  An explicit node list gathers
    exactly those rows instead (narrow, mid and wide dispatches).  Returns
    the winning `Candidate` of each dispatch (plus host candidates of
    overflow rows) as a `CandidateShortlist` carrying the true
    evaluated-candidate count.
    """
    if nodes is not None and not nodes:
        return CandidateShortlist()
    spec = cluster.spec
    dcs = _device_state(cluster)
    ctx = dcs.mirror
    req = _request(spec, workload, alpha)
    pending = []      # (vals, sel) per dispatch, decoded together
    if nodes is None:
        patches = _view_patches_of(cluster, dcs)
        sl = None
        if _shortlisted(dcs, shortlist):
            split, staged = _shortlist_plan_args(dcs, patches,
                                                 workload.priority)
            res = _shortlist_winner(dcs, staged, dcs.rep_classes()[1], req,
                                    spec, shortlist.k).tolist()
            win, sel, certain = _shortlist_decode(res, shortlist.k, alpha)
            _count_shortlist(certain, shortlist)
            if certain or shortlist.mode != "guaranteed":
                sl = (win, sel)
            else:
                split, staged = _full_args(dcs, patches, workload.priority,
                                           staged)
        else:
            split, staged = _fast_plan_args(dcs, patches, workload.priority)
        out = CandidateShortlist(_overflow_candidates(cluster, workload,
                                                      split.overflow))
        if sl is not None:
            pending.append(sl)
        else:
            res = _plan_pipeline(dcs, staged.pidx, staged.pbuf, staged.tail,
                                 req, spec, split.m_res)
            pending.append((res.tolist(), _mid_sel(dcs, split)))
        pending.extend(_chunked(dcs, staged.pidx, staged.pbuf, split.wide,
                                req, spec, ctx.cap))
    else:
        delta = (set(cluster.delta_nodes()) & set(nodes)
                 if hasattr(cluster, "delta_nodes") else set())
        patches = {d: encode_row(cluster, d, ctx.cap) for d in sorted(delta)}
        split = split_fused_nodes(dcs, patches, workload.priority, nodes)
        out = CandidateShortlist(_overflow_candidates(cluster, workload,
                                                      split.overflow))
        staged = _stage(dcs, patches)
        excluded = set(split.mid) | set(split.wide) | set(split.overflow)
        narrow = [c for c in nodes if c not in excluded]
        if narrow:
            res = _gathered_pipeline(dcs, staged.pidx, staged.pbuf,
                                     _upload(dcs, _pad_idx(narrow)), req,
                                     spec, split.m_res,
                                     len(_pad_idx(narrow)))
            pending.append((res[0].tolist(), narrow))
        pending.extend(_chunked(dcs, staged.pidx, staged.pbuf, split.mid,
                                req, spec, NARROW_M))
        pending.extend(_chunked(dcs, staged.pidx, staged.pbuf, split.wide,
                                req, spec, ctx.cap))
    out.n_candidates = len(out)
    for vals, sel in pending:
        _append_winner(out, vals, sel, patches, ctx)
    return out


def _count_shortlist(certain: bool, shortlist: ShortlistConfig) -> None:
    PATH_COUNTS["certain"] += certain
    PATH_COUNTS["fallback"] += (not certain
                                and shortlist.mode == "guaranteed")


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
    staged = _stage(dcs, _view_patches_of(cluster, dcs))
    res = _normal_pipeline(dcs, staged.pidx, staged.pbuf,
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
               allow_preempt: bool = True,
               shortlist: ShortlistConfig | None = None) -> FusedPlanResult:
    """BOTH cycles of Algorithm 1 (the engine hook for ``fused_place``).

    Three launches — the normal cycle, the sweep, the tail — and one
    readback decide the plan; wide rows re-dispatch afterwards and only
    when the normal cycle failed, and overflow rows fall back to host
    ``flextopo_imp``, as in `source_candidates_fused`.  With a
    ``shortlist`` (and more rows than its ``k``) the preemptive chain is
    the prescreen, the sweep over its ``k`` rows and the tail; in
    guaranteed mode a plan whose winner the certainty check cannot prove
    runs the full sweep and its tail on the patch tensors already on the
    device, so decisions stay those of ``shortlist=None``.
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
    thresh = workload.priority
    patches = _view_patches_of(cluster, dcs)
    if _shortlisted(dcs, shortlist):
        split, staged = _shortlist_plan_args(dcs, patches, thresh)
        res = _shortlist_plan2_pipeline(dcs, staged, dcs.rep_classes()[1],
                                        req, spec, shortlist.k).tolist()
        vals, sel = res[:NORMAL_FIELDS + WIN_FIELDS], None
        if not res[0]:
            win, sel, certain = _shortlist_decode(res[NORMAL_FIELDS:],
                                                  shortlist.k, alpha)
            _count_shortlist(certain, shortlist)
            if not certain and shortlist.mode == "guaranteed":
                # the normal cycle failed: the full sweep and its tail decide
                split, staged = _full_args(dcs, patches, thresh, staged)
                vals = res[:NORMAL_FIELDS] + _plan_pipeline(
                    dcs, staged.pidx, staged.pbuf, staged.tail, req, spec,
                    split.m_res).tolist()
                sel = _mid_sel(dcs, split)
    else:
        split, staged = _fast_plan_args(dcs, patches, thresh)
        vals = _plan2_pipeline(dcs, staged.pidx, staged.pbuf, staged.tail,
                               req, spec, split.m_res).tolist()
        sel = _mid_sel(dcs, split)

    def shortlist_out():
        out = CandidateShortlist(_overflow_candidates(cluster, workload,
                                                      split.overflow))
        out.n_candidates = len(out)
        return out

    def wide_chunks():
        return _chunked(dcs, staged.pidx, staged.pbuf, split.wide, req, spec,
                        ctx.cap)

    return _finalize_plan(vals, sel, patches, ctx, shortlist_out,
                          wide_chunks, alpha)


@functools.lru_cache(maxsize=None)
def _masked_rows(device: torch.device) -> torch.Tensor:
    return torch.tensor(_MASKED, device=device)


class BatchSourcingSession:
    """``plan_batch`` sourcing against one snapshot (counterpart of the
    reference's ``BatchSourcingSession``).

    At construction the resident sweep runs once per distinct request of
    the batch (its ``(priority, needs)``; alpha is the batch's) into one
    ``int32[R, CLS_FIELDS, N]`` tensor of class data (one a shard over a
    sharded state), R launches with no host sync between them; the
    reference's one vmapped dispatch.  A plan
    of request *i* against the batch's view then keeps the sequential
    planned-eviction semantics exactly: request *i*'s class data with the
    view's delta rows masked out (their ``anyc`` and ``cnt`` zeroed on the
    device) is merged with a `NARROW_M`-wide sweep of the patched delta
    rows and of the untouched rows above the session's gate, and reduced
    by the tail.  Untouched rows are never swept again.

    Sessions persist across ``plan_batch`` calls
    (`persistent_batch_session`) until a mutation reaches the cluster's
    ``invalidate_node``; ``reset_view_caches`` drops the per-view row
    cache on reuse.
    """

    def __init__(self, cluster: Cluster, workloads, alpha: float) -> None:
        self.cluster = cluster
        self.spec = cluster.spec
        self.alpha = float(alpha)
        self.dcs = cluster.device_state().sync()
        self.ctx = self.dcs.mirror
        self._row_cache: dict[int, tuple[int, VictimRow]] = {}
        self.reqs = [(wl.priority,) + _req_scalars(self.spec, wl)
                     for wl in workloads]
        #: reuse key of `persistent_batch_session` (alpha + request scalars)
        self.cache_key = (self.alpha, tuple(self.reqs))
        # adaptive gate, as the single-request path: the class data at
        # MIN_M when every request leaves at most MAX_ROWS_WIDE rows above
        # it (those ride each plan's gathered sweep)
        self.gate = MIN_M
        self._split_cache: dict[int, FusedSplit] = {}
        if self.dcs.count_max > MIN_M:
            for t in {t for t, _, _, _ in self.reqs}:
                elig = ((self.ctx.vp < t) & self.ctx.stored).sum(axis=1)
                if int((elig > MIN_M).sum()) > MAX_ROWS_WIDE:
                    self.gate = NARROW_M
                    break
        distinct = list(dict.fromkeys(self.reqs))
        self._slot = [distinct.index(r) for r in self.reqs]
        reqs = [FusedRequest(*r, self.alpha) for r in distinct]
        PATH_COUNTS["sessions"] += 1
        empty, empty_buf = (_each(x) for x in _empty_patch_args(self.dcs))
        data = []
        for d, s in enumerate(self.dcs.shards):
            cd = torch.empty((len(reqs), CLS_FIELDS, s.rows),
                             dtype=torch.int32, device=s.device)
            for j, r in enumerate(reqs):
                fused_class(s.nodestate, s.victims, s.drain, empty[d],
                            empty_buf[d], empty[d], m_res=self.gate,
                            resident=True, m_gather=NARROW_M, req=r,
                            spec=self.spec, out=cd[j], base=s.base)
            data.append(cd)
        #: int32[R, `CLS_FIELDS`, rows] a shard (`_one`)
        self.class_data = _one(data)
        PATH_COUNTS["session_requests"] += len(data) * len(reqs)

    def reset_view_caches(self) -> None:
        """Drop per-view state before serving a new ``plan_batch`` call
        (row encodings are keyed by `ClusterView.node_version`, which a
        fresh view restarts at zero)."""
        self._row_cache.clear()

    def _view_patches(self, view, delta) -> dict:
        """Encode the view's delta rows, re-encoding ONLY rows a later plan
        touched since they were last cached (`ClusterView.node_version`)."""
        patches = {}
        for d in delta:
            ver = view.node_version(d)
            hit = self._row_cache.get(d)
            if hit is None or hit[0] != ver:
                hit = (ver, encode_row(view, d, self.ctx.cap))
                self._row_cache[d] = hit
            patches[d] = hit[1]
        return patches

    def _route(self, view, thresh: int):
        """Delta routing shared by ``source`` and ``plan``: the view's
        delta rows encoded, the session's split for this priority (cached:
        the snapshot is fixed) less the delta rows, and the delta rows
        split into overflow (host fallback), wide (16-slot chunks) and
        dense (the plan's gathered sweep)."""
        delta = sorted(view.delta_nodes())
        patches = self._view_patches(view, delta)
        dset = set(delta)
        split = self._split_cache.get(thresh)
        if split is None:
            split = split_fused_nodes(self.dcs, {}, thresh, gate=self.gate)
            self._split_cache[thresh] = split
        mid = [w for w in split.mid if w not in dset]
        wide = [w for w in split.wide if w not in dset]
        overflow = [o for o in split.overflow if o not in dset]
        over = {d for d in delta if patches[d].overflow
                and patches[d].next_priority < thresh}
        elig = {d: int(((patches[d].vp < thresh) & patches[d].stored).sum())
                for d in delta if d not in over}
        return (delta, patches, mid, wide, overflow, sorted(over),
                [d for d in elig if elig[d] > NARROW_M],
                [d for d in elig if elig[d] <= NARROW_M])

    def _merge(self, i: int, view, req: FusedRequest, normal: bool):
        """One plan of request ``i``: the staged delta rows, then (behind
        the normal cycle when ``normal``) the gathered sweep, the masked
        class data and the tail.  Returns ``(vals, sel, route, staged)``
        after one readback; ``vals`` int32[5 + `WIN_FIELDS`] with
        ``normal``, else int32[`WIN_FIELDS`]."""
        route = self._route(view, req.thresh)
        delta, patches, mid, _, _, _, _, d_dense = route
        gather = sorted(d_dense) + mid
        gidx = _pad_idx(gather)     # at least 4 (sentinel rows never win)
        nd = len(delta)
        # every delta row rides the patch buffer (the normal cycle needs the
        # view's exact free masks; the class data's winners are untouched
        # rows, which no patch row covers)
        staged = _stage(self.dcs, patches,
                        np.concatenate([np.asarray(delta, np.int32), gidx]),
                        pending=False)
        n = self.dcs.n_rows
        sel = {n + j: node for j, node in enumerate(gather)}
        shards = self.dcs.shards
        head = NORMAL_FIELDS if normal else 0
        out = torch.empty(head + WIN_FIELDS, dtype=torch.int32,
                          device=self.dcs.device)
        skip = None
        if normal:
            _normal(shards, staged.pidx, staged.pbuf, req, self.spec,
                    out=out[:NORMAL_FIELDS])
            skip = out[:1]
        pidx, pbuf, tail = (_each(x) for x in (staged.pidx, staged.pbuf,
                                                staged.tail))
        gidx = [t[nd:] for t in tail]
        delta = np.asarray(delta, np.int64)
        merged = []
        for d, s in enumerate(shards):
            cls_g = fused_class(s.nodestate, s.victims, s.drain, pidx[d],
                                pbuf[d], gidx[d], m_res=NARROW_M,
                                resident=False, m_gather=NARROW_M, req=req,
                                spec=self.spec, skip=_on(skip, s.device),
                                base=s.base)
            cd = torch.cat([_each(self.class_data)[d][self._slot[i]], cls_g],
                           dim=1)
            # the delta rows' class data is stale: their patched rows ride
            # the gathered sweep
            if len(shards) == 1:
                own = tail[d][:nd]
            else:
                own = delta[(delta >= s.base) & (delta < s.base + s.rows)]
                own = torch.from_numpy(own - s.base).to(s.device)
            if len(own):
                cd[_masked_rows(s.device)[:, None], own[None, :]] = 0
            merged.append(cd)
        _sweep_tail(shards, pidx, pbuf, gidx, req, self.spec, m_res=NARROW_M,
                    resident=True, m_gather=NARROW_M, skip=skip,
                    out=out[head:], cls=merged)
        PATH_COUNTS["merge_normal" if normal else "merge"] += len(shards)
        return out.tolist(), sel, route, staged

    def _wide(self, staged: _Staged, d_wide, wide, req):
        return _chunked(self.dcs, staged.pidx, staged.pbuf, d_wide + wide,
                        req, self.spec, self.ctx.cap)

    def source(self, view, workload: WorkloadSpec,
               i: int) -> CandidateShortlist:
        """Request ``i``'s sourcing against ``view`` (the preemption phase
        alone): the merge and the wide chunks."""
        req = FusedRequest(*self.reqs[i], self.alpha)
        vals, sel, route, staged = self._merge(i, view, req, normal=False)
        _, patches, _, wide, overflow, d_over, d_wide, _ = route
        out = CandidateShortlist(_overflow_candidates(
            view, workload, overflow + d_over))
        out.n_candidates = len(out)
        _append_winner(out, vals, sel, patches, self.ctx)
        for chunk_vals, chunk in self._wide(staged, d_wide, wide, req):
            _append_winner(out, chunk_vals, chunk, patches, self.ctx)
        return out

    def plan(self, view, workload: WorkloadSpec, i: int,
             normal: bool = True) -> FusedPlanResult:
        """Both Algorithm 1 cycles for request ``i``: the normal cycle over
        the view-patched node state, then the merge behind its ``found``,
        one readback; the wide chunks only when the normal cycle failed.
        ``normal=False`` is for a plan whose normal cycle already failed
        on this view: the merge alone."""
        req = FusedRequest(*self.reqs[i], self.alpha)
        vals, sel, route, staged = self._merge(i, view, req, normal=normal)
        if not normal:
            vals = [0] * NORMAL_FIELDS + vals
        _, patches, _, wide, overflow, d_over, d_wide, _ = route

        def shortlist():
            out = CandidateShortlist(_overflow_candidates(
                view, workload, overflow + d_over))
            out.n_candidates = len(out)
            return out

        def wide_chunks():
            return self._wide(staged, d_wide, wide, req)

        return _finalize_plan(vals, sel, patches, self.ctx, shortlist,
                              wide_chunks, self.alpha)


def persistent_batch_session(cluster: Cluster, workloads,
                             alpha: float) -> BatchSourcingSession:
    """The engine's ``batch_factory``, with reuse across calls.

    The first call on a cluster registers one ``invalidate_node`` listener
    that voids the cached session on ANY mutation (bind/evict/restore), the
    choke point that keeps the resident state coherent.  A ``plan_batch``
    with unchanged cluster state, the same request classes and the same
    alpha reuses the session: its class data is served again and only the
    per-plan launches run.  The slot lives on the cluster, so a dropped
    cluster and its session are collected together.
    """
    entry = getattr(cluster, "_batch_session_slot", None)
    if entry is None:
        entry = {"session": None}

        def _void(node, _entry=entry):
            _entry["session"] = None

        cluster.add_dirty_listener(_void)
        cluster._batch_session_slot = entry
    spec = cluster.spec
    key = (float(alpha),
           tuple((wl.priority,) + _req_scalars(spec, wl) for wl in workloads))
    session = entry["session"]
    if session is not None and session.cache_key == key:
        session.reset_view_caches()
        return session
    session = BatchSourcingSession(cluster, workloads, alpha)
    entry["session"] = session
    return session


def warmup_fused(cluster: Cluster, alpha: float = DEFAULT_ALPHA,
                 batch: int = 8, workloads=None,
                 shortlist: ShortlistConfig | None = None) -> None:
    """Build the kernels and fill the caches before the first plan.

    Opt-in via ``TopoScheduler(..., warmup=True)``: drives real sourcing
    (pure reads against copy-on-write views, so cluster state is
    untouched) for each preemptor class, once against the clean state and
    once against a view with a delta (the shortlist too when given), plus
    one batch session, so the kernels' build, the resident upload and the
    routing caches are paid at construction instead of on the first
    plans.  ``workloads`` defaults to the Table 3 classes.
    """
    from .workload import table3_workloads

    workloads = list(table3_workloads() if workloads is None else workloads)
    cluster.device_state().sync()
    for wl in workloads:
        source_candidates_fused(cluster, wl, None, alpha=alpha)
        plan_fused(cluster, wl, alpha=alpha)
        plan_normal_fused(cluster, wl)
        if shortlist is not None:
            plan_fused(cluster, wl, alpha=alpha, shortlist=shortlist)
        view = cluster.view()
        for node in range(cluster.num_nodes):    # fabricate one view delta
            victims = view.victims_on(node, wl.priority)
            if victims:
                view.plan_evict(victims[0].uid)
                source_candidates_fused(view, wl, None, alpha=alpha)
                plan_fused(view, wl, alpha=alpha)
                plan_normal_fused(view, wl)
                if shortlist is not None:
                    plan_fused(view, wl, alpha=alpha, shortlist=shortlist)
                break
    if batch > 1 and workloads:
        session = BatchSourcingSession(
            cluster, tuple((workloads * batch)[:batch]), alpha)
        session.source(cluster.view(), workloads[0], 0)
        session.plan(cluster.view(), workloads[0], 0)


register_engine("imp_batched", batched=True, needs_alpha=True,
                fused_filter=True, fused_place=True, plan_fn=plan_fused,
                normal_fn=plan_normal_fused,
                batch_factory=persistent_batch_session,
                warmup_fn=warmup_fused,
                supports_shortlist=True)(source_candidates_fused)

# the full-sweep oracle: the same functions with the shortlist off (the
# scheduler's shortlist arguments are ignored), as in the reference
register_engine("imp_batched_full", batched=True, needs_alpha=True,
                fused_filter=True, fused_place=True, plan_fn=plan_fused,
                normal_fn=plan_normal_fused,
                batch_factory=persistent_batch_session,
                warmup_fn=warmup_fused)(source_candidates_fused)
