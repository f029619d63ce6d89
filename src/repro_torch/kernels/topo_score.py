"""Batched victim-subset scoring on the GPU (paper §3.4 hot loop).

A victim subset is one int32 lane: its freed-GPU/CoreGroup bitmasks.
Per-NUMA availability is ``popcount(mask & numa_mask)`` and the Eq. 1 score
is a few f32 operations per lane.  Three hand-written CUDA kernels in
``csrc/topo_score.cu`` share that math; each has its plain PyTorch version
in this module:

====================  =========================  ===============================
wrapper               plain version              replaces (repro.kernels.topo_score)
====================  =========================  ===============================
``topo_score``        ``topo_score_plain``       ``topo_score_pallas``
``topo_score_argmax`` ``topo_score_argmax_plain`` ``topo_score_argmax_pallas``
``placement_tier``    ``placement_tier_plain``   ``placement_tier_pallas``
====================  =========================  ===============================

A wrapper runs the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; anything else raises.  Each kernel
takes the tier from the lane's per-NUMA counts with no division, the rule
of the fused kernels, and one lane a thread at the sizes a plan gives it;
``topo_score`` and ``placement_tier`` take four lanes a thread as 16-byte
vectors where the lanes exceed one grid of the card and every tensor is
16-byte aligned.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.

``topo_score_argmax`` also reduces each tile of ``TILE = 8 * 128`` lanes to
(smallest feasible subset size, best tier, best score, flat index of that
winner) and takes a per-lane filtering mask ``ok``, so the ``imp_pallas``
engine scores every subset size of a node in ONE launch.  The engine keeps
its reference name so that configurations and protocols carry over.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.cluster import MAX_DENSE_VICTIMS
from repro_torch.core.engines import register_engine
from repro_torch.core.placement_device import popcount32
from repro_torch.core.preemption import flextopo_imp
from repro_torch.core.scoring import Candidate
from repro_torch.core.topology import ServerSpec
from repro_torch.core.workload import TopoPolicy

from . import _build

TIER_VALUES = (1.0, 0.5, 0.1)
ROWS_PER_TILE = 8
LANES = 128
TILE = ROWS_PER_TILE * LANES
#: k fill value for padding lanes in the argmax kernel (also the "no
#: feasible subset in this tile" sentinel of the per-tile k-min output).
K_INFEASIBLE = np.int32(2**30)
_MAX_NUMA = 8      # TopoParams array widths in csrc/topo_score.cu
_MAX_SOCKETS = 8


@dataclasses.dataclass(frozen=True)
class TopoRequest:
    need_gpus: int
    need_cgs: int
    cgs_per_bundle: int
    alpha: float = 0.5


class _Params(ctypes.Structure):
    """ctypes mirror of ``struct TopoParams`` in csrc/topo_score.cu."""

    _fields_ = [
        ("num_numa", ctypes.c_int),
        ("num_sockets", ctypes.c_int),
        ("need_gpus", ctypes.c_int),
        ("need_cgs", ctypes.c_int),
        ("cgs_per_bundle", ctypes.c_int),
        ("numa_gpu", ctypes.c_int * _MAX_NUMA),
        ("numa_cg", ctypes.c_int * _MAX_NUMA),
        ("socket_of_numa", ctypes.c_int * _MAX_NUMA),
        ("alpha", ctypes.c_float),
        ("one_minus_alpha", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=64)
def _params(spec: ServerSpec, req: TopoRequest) -> _Params:
    if spec.num_numa > _MAX_NUMA or spec.num_sockets > _MAX_SOCKETS:
        raise ValueError(f"{spec.name}: the kernels take at most {_MAX_NUMA} "
                         f"NUMA nodes and {_MAX_SOCKETS} sockets")
    # the kernels' tier rule sums a socket's NUMA nodes as k adjacent bytes
    k = max(1, sum(spec.socket_of_numa(u) == 0 for u in range(spec.num_numa)))
    if any(spec.socket_of_numa(u) != u // k for u in range(spec.num_numa)):
        raise ValueError(f"{spec.name}: the kernels take sockets of "
                         "consecutive NUMA nodes")
    p = _Params()       # zero-filled: no NUMA mask past num_numa
    p.num_numa = spec.num_numa
    p.num_sockets = spec.num_sockets
    p.need_gpus = req.need_gpus
    p.need_cgs = req.need_cgs
    p.cgs_per_bundle = req.cgs_per_bundle
    for u in range(spec.num_numa):
        p.numa_gpu[u] = int(spec.numa_gpu_masks[u])
        p.numa_cg[u] = int(spec.numa_cg_masks[u])
        p.socket_of_numa[u] = spec.socket_of_numa(u)
    # the reference rounds alpha to f32, and computes (1 - alpha) in double
    # before rounding it to f32: do the same here (trap 1 in the .cu file)
    p.alpha = float(np.float32(req.alpha))
    p.one_minus_alpha = float(np.float32(1.0 - req.alpha))
    return p


# ---------------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------------

def _tier_score_plain(g: torch.Tensor, c: torch.Tensor, prio: torch.Tensor,
                      spec: ServerSpec, req: TopoRequest
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tier int32, Eq. 1 score f32) per lane, as the reference computes
    them: one rounding per f32 operation, no fused multiply-add."""
    zero = torch.zeros_like(g)
    sock_units = [zero] * spec.num_sockets
    sock_cg = [zero] * spec.num_sockets
    glob_units = zero
    glob_cg = zero
    numa_ok = torch.zeros_like(g, dtype=torch.bool)
    for u in range(spec.num_numa):
        cnt_gpu = popcount32(g & int(spec.numa_gpu_masks[u]))
        cnt_cg = popcount32(c & int(spec.numa_cg_masks[u]))
        if req.cgs_per_bundle > 0:
            units = torch.minimum(cnt_gpu, cnt_cg // req.cgs_per_bundle)
        else:
            units = cnt_gpu
        numa_ok = numa_ok | ((units >= req.need_gpus)
                             & (cnt_cg >= req.need_cgs))
        s = spec.socket_of_numa(u)
        sock_units[s] = sock_units[s] + units
        sock_cg[s] = sock_cg[s] + cnt_cg
        glob_units = glob_units + units
        glob_cg = glob_cg + cnt_cg
    sock_ok = torch.zeros_like(numa_ok)
    for s in range(spec.num_sockets):
        sock_ok = sock_ok | ((sock_units[s] >= req.need_gpus)
                             & (sock_cg[s] >= req.need_cgs))
    glob_ok = (glob_units >= req.need_gpus) & (glob_cg >= req.need_cgs)
    tier = torch.where(numa_ok, 0, torch.where(
        sock_ok, 1, torch.where(glob_ok, 2, 3))).to(torch.int32)

    f32 = dict(dtype=torch.float32, device=g.device)
    tv = torch.tensor(TIER_VALUES + (0.0,), **f32)
    topo = tv[tier.to(torch.int64)]
    one = torch.ones_like(topo)
    prio_term = torch.where(
        prio > 0, torch.div(one, torch.clamp(prio, min=1).to(torch.float32)),
        one)
    alpha = torch.tensor(np.float32(req.alpha), **f32)
    one_minus_alpha = torch.tensor(np.float32(1.0 - req.alpha), **f32)
    score = alpha * prio_term + one_minus_alpha * topo
    score = torch.where(tier < 3, score, torch.tensor(-np.inf, **f32))
    return tier, score


def topo_score_plain(combo_gpu, combo_cg, prio, spec: ServerSpec,
                     req: TopoRequest):
    """Plain version of `topo_score`: (tier int32[n], score f32[n])."""
    return _tier_score_plain(combo_gpu, combo_cg, prio, spec, req)


def _tiles(x: torch.Tensor, fill: int, n_pad: int) -> torch.Tensor:
    out = torch.full((n_pad,), fill, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out.view(n_pad // TILE, TILE)


def topo_score_argmax_plain(combo_gpu, combo_cg, prio, k, spec: ServerSpec,
                            req: TopoRequest, ok=None):
    """Plain version of `topo_score_argmax`, tile by tile as the reference
    reduces: kmin, then the lowest tier, the highest score and the lowest
    flat index among the lanes that survive each step."""
    n = combo_gpu.shape[0]
    if ok is None:
        ok = torch.ones_like(combo_gpu)
    tier, score = _tier_score_plain(combo_gpu, combo_cg, prio, spec, req)
    live = ok != 0
    tier = torch.where(live, tier, 3).to(torch.int32)
    score = torch.where(live, score, torch.tensor(-np.inf, dtype=score.dtype,
                                                  device=score.device))
    n_pad = -(-n // TILE) * TILE
    big = int(K_INFEASIBLE)
    t2 = _tiles(tier, 3, n_pad)             # pad lanes: ok = 0 -> tier 3
    s2 = _tiles(score, 0, n_pad)
    k2 = _tiles(k, big, n_pad)
    feas = t2 < 3
    kmin = torch.where(feas, k2, big).amin(dim=1).to(torch.int32)
    sel = feas & (k2 == kmin[:, None])
    btier = torch.where(sel, t2, 3).amin(dim=1).to(torch.int32)
    sel = sel & (t2 == btier[:, None])
    bscore = torch.where(sel, s2, -np.inf).amax(dim=1).to(torch.float32)
    sel = sel & (s2 == bscore[:, None])
    flat = torch.arange(TILE, dtype=torch.int32, device=t2.device)
    local = torch.where(sel, flat, big).amin(dim=1)
    start = torch.arange(n_pad // TILE, dtype=torch.int32,
                         device=t2.device) * TILE
    bidx = (start + local).to(torch.int32)
    return tier, score, kmin, btier, bscore, bidx


def placement_tier_plain(free_gpu, free_cg, spec: ServerSpec,
                         req: TopoRequest):
    """Plain version of `placement_tier`: int32[n] tier per node."""
    tier, _ = _tier_score_plain(free_gpu, free_cg, torch.zeros_like(free_gpu),
                                spec, req)
    return tier


# ---------------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------------

def _checked(*xs: torch.Tensor) -> tuple[int, bool]:
    """Validate the lane tensors; returns (n, whether they lie on CUDA)."""
    n = xs[0].shape[0]
    dev = xs[0].device
    for x in xs:
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError("lane inputs must be contiguous 1-D int32 "
                             f"tensors, got {x.dtype} {tuple(x.shape)}")
        if x.shape[0] != n or x.device != dev:
            raise ValueError("lane inputs must share one length and device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and n >= 2**31 - TILE:
        raise ValueError(f"{n} lanes exceed the kernels' int32 indexing")
    return n, dev.type == "cuda"


def _vec(*xs: torch.Tensor) -> int:
    """1 when every tensor is 16-byte aligned: K2's and K3's kernels may
    then take four lanes a step as one vector."""
    return int(all(x.data_ptr() % 16 == 0 for x in xs))


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.topo_score_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("topo_score"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the lane launchers' argument types on a loaded build of
    ``csrc/topo_score.cu``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(_Params)
    lib.topo_score_launch.argtypes = [vp, vp, vp, vp, vp, ci, pp, ci, vp]
    lib.topo_score_argmax_launch.argtypes = [vp] * 11 + [ci, pp, vp]
    lib.placement_tier_launch.argtypes = [vp, vp, vp, ci, pp, ci, vp]
    for fn in (lib.topo_score_launch, lib.topo_score_argmax_launch,
               lib.placement_tier_launch):
        fn.restype = ci
    lib.topo_score_error_string.argtypes = [ci]
    lib.topo_score_error_string.restype = ctypes.c_char_p
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def topo_score(combo_gpu: torch.Tensor, combo_cg: torch.Tensor,
               prio: torch.Tensor, spec: ServerSpec, req: TopoRequest
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tier (int32[n], 3 = infeasible) and Eq. 1 score (f32[n], -inf where
    infeasible) per subset.  Counterpart of ``topo_score_pallas``."""
    n, on_cuda = _checked(combo_gpu, combo_cg, prio)
    if not on_cuda:
        return topo_score_plain(combo_gpu, combo_cg, prio, spec, req)
    tier = torch.empty_like(combo_gpu)
    score = torch.empty(n, dtype=torch.float32, device=combo_gpu.device)
    if n == 0:
        return tier, score
    lib = _lib()
    with torch.cuda.device(combo_gpu.device):
        code = lib.topo_score_launch(
            combo_gpu.data_ptr(), combo_cg.data_ptr(), prio.data_ptr(),
            tier.data_ptr(), score.data_ptr(), n,
            ctypes.byref(_params(spec, req)),
            _vec(combo_gpu, combo_cg, prio, tier, score), _stream(combo_gpu))
    _raise_on(lib, code, "topo_score")
    topo_score.launches += 1
    return tier, score


topo_score.launches = 0


def topo_score_argmax(combo_gpu: torch.Tensor, combo_cg: torch.Tensor,
                      prio: torch.Tensor, k: torch.Tensor, spec: ServerSpec,
                      req: TopoRequest, ok: torch.Tensor | None = None):
    """Single-launch scoring of subsets of EVERY size plus the per-tile
    running argmax.  Counterpart of ``topo_score_argmax_pallas``.

    ``ok`` is the filtering mask: lanes with ``ok == 0`` (subsets touching
    victims the preemptor may not evict) are masked infeasible inside the
    kernel instead of being pre-filtered on the host.

    Returns (tier int32[n], score f32[n], kmin int32[T], btier int32[T],
    bscore f32[T], bidx int32[T]) with T = ceil(n / TILE);
    ``kmin[t] == K_INFEASIBLE`` marks a tile with no feasible subset, and
    ``bidx`` is the *global* flat index of tile t's winner under the
    (k, tier-then-score, index) order.
    """
    if ok is None:
        ok = torch.ones_like(combo_gpu)
    n, on_cuda = _checked(combo_gpu, combo_cg, prio, k, ok)
    if not on_cuda:
        return topo_score_argmax_plain(combo_gpu, combo_cg, prio, k, spec,
                                       req, ok=ok)
    dev = combo_gpu.device
    n_tiles = -(-n // TILE)
    tier = torch.empty_like(combo_gpu)
    score = torch.empty(n, dtype=torch.float32, device=dev)
    kmin = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    btier = torch.empty_like(kmin)
    bscore = torch.empty(n_tiles, dtype=torch.float32, device=dev)
    bidx = torch.empty_like(kmin)
    if n == 0:
        return tier, score, kmin, btier, bscore, bidx
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.topo_score_argmax_launch(
            combo_gpu.data_ptr(), combo_cg.data_ptr(), prio.data_ptr(),
            k.data_ptr(), ok.data_ptr(), tier.data_ptr(), score.data_ptr(),
            kmin.data_ptr(), btier.data_ptr(), bscore.data_ptr(),
            bidx.data_ptr(), n, ctypes.byref(_params(spec, req)),
            _stream(combo_gpu))
    _raise_on(lib, code, "topo_score_argmax")
    topo_score_argmax.launches += 1
    return tier, score, kmin, btier, bscore, bidx


topo_score_argmax.launches = 0


def placement_tier(free_gpu: torch.Tensor, free_cg: torch.Tensor,
                   spec: ServerSpec, req: TopoRequest) -> torch.Tensor:
    """Per-node placement tier (0/1/2, 3 = infeasible) from the nodes' free
    masks, bit-matching ``placement.best_tier`` for the request's
    ``(need_gpus, need_cgs, cgs_per_bundle)`` encoding.  Counterpart of
    ``placement_tier_pallas``."""
    n, on_cuda = _checked(free_gpu, free_cg)
    if not on_cuda:
        return placement_tier_plain(free_gpu, free_cg, spec, req)
    tier = torch.empty_like(free_gpu)
    if n == 0:
        return tier
    lib = _lib()
    with torch.cuda.device(free_gpu.device):
        code = lib.placement_tier_launch(
            free_gpu.data_ptr(), free_cg.data_ptr(), tier.data_ptr(), n,
            ctypes.byref(_params(spec, req)), _vec(free_gpu, free_cg, tier),
            _stream(free_gpu))
    _raise_on(lib, code, "placement_tier")
    placement_tier.launches += 1
    return tier


placement_tier.launches = 0

#: every kernel wrapper of this module (their ``launches`` counters)
WRAPPERS = (topo_score, topo_score_argmax, placement_tier)


# ---------------------------------------------------------------------------------
# IMP engine backed by the kernel (scheduler engine "imp_pallas")
# ---------------------------------------------------------------------------------

def _all_size_combos(free_gpu: int, free_cg: int, vg, vc, vp):
    """Every victim subset as its slot-bitmask id: freed masks, priority sum
    and subset size for ids 0..2^m-1 (id 0 = evict nothing)."""
    m = len(vg)
    ids = np.arange(1 << m, dtype=np.int64)
    cg = np.full(ids.shape, free_gpu, np.int64)
    cc = np.full(ids.shape, free_cg, np.int64)
    pr = np.zeros(ids.shape, np.int64)
    kk = np.zeros(ids.shape, np.int64)
    for j in range(m):
        b = (ids >> j) & 1
        cg |= b * int(vg[j])
        cc |= b * int(vc[j])
        pr += b * int(vp[j])
        kk += b
    return ids, cg, cc, pr, kk


@register_engine("imp_pallas")
def flextopo_imp_pallas(cluster, workload, node):
    """Same semantics as ``preemption.flextopo_imp``, but every subset size
    is evaluated in ONE `topo_score_argmax` launch on ``cluster.device``:
    the per-tile argmax gives the smallest feasible size, and candidates
    are read off the dense tier output at that size only.

    Eligible victims are a prefix of the (priority, uid) order, so the
    preemptor-priority filter is a host-side slice; the kernel's filtering
    mask (``ok``) additionally zeroes any lane whose subset escapes that
    eligibility.  A node with more than `MAX_DENSE_VICTIMS` victims (2^m
    lanes would blow up) goes to the exact host engine, counted in
    ``flextopo_imp_pallas.overflow``; ``flextopo_imp_pallas.calls`` counts
    every per-node call."""
    flextopo_imp_pallas.calls += 1
    spec = cluster.spec
    victims = cluster.victims_on(node, workload.priority)
    if len(victims) > MAX_DENSE_VICTIMS:
        flextopo_imp_pallas.overflow += 1
        return flextopo_imp(cluster, workload, node)
    free_gpu, free_cg = cluster.free_masks(node)
    need_gpus = workload.gpus_per_instance
    need_cgs = workload.coregroups_per_instance(spec.coregroup_size)
    bundle = workload.numa_policy == TopoPolicy.GUARANTEED
    req = TopoRequest(
        need_gpus=need_gpus, need_cgs=need_cgs,
        cgs_per_bundle=(need_cgs // need_gpus if (bundle and need_gpus) else 0))
    vg = [v.gpu_mask for v in victims]
    vc = [v.cg_mask for v in victims]
    vp = [v.priority for v in victims]
    ids, cg, cc, pr, kk = _all_size_combos(free_gpu, free_cg, vg, vc, vp)
    elig_bits = sum(1 << j for j, v in enumerate(victims)
                    if v.priority < workload.priority)
    ok = (ids & ~np.int64(elig_bits)) == 0
    # the host builds int64 and casts to int32 here, as the reference does
    # (masks and priority sums of <= 16 victims fit)
    lanes = torch.from_numpy(
        np.stack([cg, cc, pr, kk, ok]).astype(np.int32)).to(cluster.device)
    tier, _, kmin, _, _, _ = topo_score_argmax(
        lanes[0], lanes[1], lanes[2], lanes[3], spec, req, ok=lanes[4])
    got = torch.cat((kmin, tier)).cpu().numpy()    # one device->host copy
    kmin, tier = got[:kmin.shape[0]], got[kmin.shape[0]:]
    k_star = int(np.min(kmin))
    if k_star >= int(K_INFEASIBLE):
        return []
    at_min = np.nonzero((tier < 3) & (kk == k_star))[0]
    return [
        Candidate(
            node=node,
            victims=tuple(sorted(
                victims[j].uid for j in range(len(victims))
                if (int(ids[i]) >> j) & 1)),
            tier=int(tier[i]),
            priority_sum=int(pr[i]),
        )
        for i in at_min
    ]


flextopo_imp_pallas.calls = 0
flextopo_imp_pallas.overflow = 0
