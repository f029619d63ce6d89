"""Tiered topology-aware placement inside one server (paper §3.4 Sorting).

Placement semantics
-------------------
A request of (g GPUs, c CoreGroups) is decomposed into g *bundles*, each
pairing one GPU with ``c // g`` CoreGroups that are ``localized`` to the same
NUMA node the GPU is ``nearby`` (guaranteed CPU↔GPU locality, paper Table 1
"NUMA: Guaranteed").  The *topology tier* of a placement is the paper's
piecewise score:

    tier 0 (high)   — every bundle in one single NUMA node
    tier 1 (medium) — bundles span NUMA nodes but stay within one socket
    tier 2 (low)    — bundles cross sockets

``best_tier`` computes the best achievable tier for given free masks (used by
IMP feasibility); ``place`` additionally commits to concrete GPU/CoreGroup
bitmasks.  ``place_blind`` is the topology-UNaware baseline (lowest free index
first) that reproduces the default/Gödel-standard allocator behaviour.

This module is the host implementation that the scheduler's normal cycle,
Guaranteed Filtering and the host engines call.  The CUDA kernels in
`repro_torch.kernels.topo_score` evaluate the same tier feasibility as
popcount lane math (``placement_tier`` is the per-node twin of
``best_tier``).
"""
from __future__ import annotations

import dataclasses

from .topology import ServerSpec

INFEASIBLE = 3  # tier value used for "does not fit at all"


@dataclasses.dataclass(frozen=True)
class Placement:
    gpu_mask: int
    cg_mask: int
    tier: int  # 0 NUMA / 1 socket / 2 cross-socket


def _bits(mask: int, n: int) -> list[int]:
    return [i for i in range(n) if mask >> i & 1]


def _lowest_bits(mask: int, k: int, n: int) -> int | None:
    """Lowest ``k`` set bits of ``mask``, or ``None`` when fewer are set.

    ``None`` (not an exception) keeps the feasibility API uniform: a caller
    racing against a concurrent allocation sees an infeasible placement,
    not a crashed planner.
    """
    out = 0
    for i in range(n):
        if k == 0:
            break
        if mask >> i & 1:
            out |= 1 << i
            k -= 1
    if k:
        return None
    return out


def min_tier_for(spec: ServerSpec, need_gpus: int) -> int:
    """Best tier physically achievable for a g-GPU instance on this SKU."""
    if need_gpus <= spec.gpus_per_numa:
        return 0
    if need_gpus <= spec.gpus_per_numa * spec.numa_per_socket:
        return 1
    return 2


def _numa_capacity(
    spec: ServerSpec,
    free_gpu_mask: int,
    free_cg_mask: int,
    cgs_per_bundle: int,
) -> list[tuple[int, int, int]]:
    """Per NUMA node: (#free gpus, #free coregroups, #whole bundles)."""
    out = []
    for u in range(spec.num_numa):
        fg = (free_gpu_mask & int(spec.numa_gpu_masks[u])).bit_count()
        fc = (free_cg_mask & int(spec.numa_cg_masks[u])).bit_count()
        bundles = min(fg, fc // cgs_per_bundle) if cgs_per_bundle else fg
        out.append((fg, fc, bundles))
    return out


def best_tier(
    spec: ServerSpec,
    free_gpu_mask: int,
    free_cg_mask: int,
    need_gpus: int,
    need_cgs: int,
    bundle_locality: bool = True,
) -> int:
    """Best achievable topology tier for the request, or INFEASIBLE.

    With ``bundle_locality`` (numa_policy=Guaranteed) each GPU must come with
    its share of CoreGroups from its own NUMA node; without it, GPU and
    CoreGroup counts are checked independently (numa_policy=None workloads).
    """
    if need_gpus == 0:
        # CPU-only request: tier by CoreGroup spread.
        for u in range(spec.num_numa):
            if (free_cg_mask & int(spec.numa_cg_masks[u])).bit_count() >= need_cgs:
                return 0
        for s in range(spec.num_sockets):
            if (free_cg_mask & int(spec.socket_cg_masks[s])).bit_count() >= need_cgs:
                return 1
        return 2 if free_cg_mask.bit_count() >= need_cgs else INFEASIBLE

    cgs_per_bundle = need_cgs // need_gpus if bundle_locality else 0
    caps = _numa_capacity(spec, free_gpu_mask, free_cg_mask, cgs_per_bundle)
    if bundle_locality:
        def scope_ok(numas: list[int]) -> bool:
            # need whole bundles for every GPU plus enough CoreGroups overall
            # (leftover CoreGroups beyond whole bundles may come from anywhere
            # within the scope)
            bundles = sum(caps[u][2] for u in numas)
            free_cg = sum(caps[u][1] for u in numas)
            return bundles >= need_gpus and free_cg >= need_cgs

    else:
        def scope_ok(numas: list[int]) -> bool:
            return (
                sum(caps[u][0] for u in numas) >= need_gpus
                and sum(caps[u][1] for u in numas) >= need_cgs
            )

    for u in range(spec.num_numa):
        if scope_ok([u]):
            return 0
    for s in range(spec.num_sockets):
        numas = [u for u in range(spec.num_numa) if spec.socket_of_numa(u) == s]
        if scope_ok(numas):
            return 1
    if scope_ok(list(range(spec.num_numa))):
        return 2
    return INFEASIBLE


def place(
    spec: ServerSpec,
    free_gpu_mask: int,
    free_cg_mask: int,
    need_gpus: int,
    need_cgs: int,
    bundle_locality: bool = True,
) -> Placement | None:
    """Commit a concrete topology-aware placement at the best achievable tier."""
    tier = best_tier(spec, free_gpu_mask, free_cg_mask, need_gpus, need_cgs,
                     bundle_locality)
    if tier == INFEASIBLE:
        return None
    # choose the scope (list of NUMA ids) matching the tier, best-fit
    cgs_per_bundle = need_cgs // need_gpus if (bundle_locality and need_gpus) else 0
    caps = _numa_capacity(spec, free_gpu_mask, free_cg_mask, cgs_per_bundle)

    def scope_capacity(numas: list[int]) -> tuple[int, int]:
        if bundle_locality and need_gpus:
            return (sum(caps[u][2] for u in numas), sum(caps[u][1] for u in numas))
        return (sum(caps[u][0] for u in numas), sum(caps[u][1] for u in numas))

    if tier == 0:
        scopes = [[u] for u in range(spec.num_numa)]
    elif tier == 1:
        scopes = [
            [u for u in range(spec.num_numa) if spec.socket_of_numa(u) == s]
            for s in range(spec.num_sockets)
        ]
    else:
        scopes = [list(range(spec.num_numa))]

    # best-fit: pick the feasible scope with the least leftover bundle capacity
    feasible = []
    for numas in scopes:
        units, cg_avail = scope_capacity(numas)
        if units >= need_gpus and cg_avail >= need_cgs:
            feasible.append((units - need_gpus, numas))
    if not feasible:
        return None
    _, numas = min(feasible, key=lambda t: (t[0], t[1]))

    gpu_mask = 0
    cg_mask = 0
    remaining_gpus = need_gpus
    remaining_cgs = need_cgs
    for u in numas:
        if remaining_gpus == 0:
            break
        u_free_g = free_gpu_mask & int(spec.numa_gpu_masks[u])
        u_free_c = free_cg_mask & int(spec.numa_cg_masks[u])
        take = min(remaining_gpus, caps[u][2] if (bundle_locality and need_gpus) else caps[u][0])
        if take <= 0:
            continue
        g_sel = _lowest_bits(u_free_g, take, spec.num_gpus)
        if g_sel is None:  # raced against a concurrent allocation
            return None
        gpu_mask |= g_sel
        remaining_gpus -= take
        if bundle_locality and cgs_per_bundle:
            c_take = min(take * cgs_per_bundle, remaining_cgs)
            c_sel = _lowest_bits(u_free_c, c_take, spec.num_coregroups)
            if c_sel is None:
                return None
            cg_mask |= c_sel
            remaining_cgs -= c_take
    # remaining CoreGroups (non-bundle leftovers or locality-free) from scope order
    if remaining_cgs:
        for u in numas:
            u_free_c = free_cg_mask & int(spec.numa_cg_masks[u]) & ~cg_mask
            avail = u_free_c.bit_count()
            take = min(avail, remaining_cgs)
            if take:
                c_sel = _lowest_bits(u_free_c, take, spec.num_coregroups)
                if c_sel is None:
                    return None
                cg_mask |= c_sel
                remaining_cgs -= take
            if remaining_cgs == 0:
                break
    if remaining_gpus or remaining_cgs:
        return None  # defensive; best_tier said feasible
    return Placement(gpu_mask=gpu_mask, cg_mask=cg_mask, tier=tier)


def place_blind(
    spec: ServerSpec,
    free_gpu_mask: int,
    free_cg_mask: int,
    need_gpus: int,
    need_cgs: int,
) -> Placement | None:
    """Topology-blind baseline: lowest free indices first (default scheduler)."""
    if free_gpu_mask.bit_count() < need_gpus or free_cg_mask.bit_count() < need_cgs:
        return None
    gpu_mask = _lowest_bits(free_gpu_mask, need_gpus, spec.num_gpus) if need_gpus else 0
    cg_mask = _lowest_bits(free_cg_mask, need_cgs, spec.num_coregroups) if need_cgs else 0
    if gpu_mask is None or cg_mask is None:
        return None
    return Placement(gpu_mask=gpu_mask, cg_mask=cg_mask,
                     tier=achieved_tier(spec, gpu_mask))


def achieved_tier(spec: ServerSpec, gpu_mask: int) -> int:
    """Tier actually achieved by a committed GPU set (for hit accounting)."""
    if gpu_mask == 0:
        return 0
    numas = {spec.numa_of_gpu(g) for g in _bits(gpu_mask, spec.num_gpus)}
    if len(numas) == 1:
        return 0
    sockets = {spec.socket_of_numa(u) for u in numas}
    return 1 if len(sockets) == 1 else 2


def bundle_locality_ok(spec: ServerSpec, gpu_mask: int, cg_mask: int,
                       need_cgs_per_gpu: int) -> bool:
    """Check the guaranteed-NUMA bundle constraint on a committed placement."""
    cg_left = cg_mask
    for g in _bits(gpu_mask, spec.num_gpus):
        u = spec.numa_of_gpu(g)
        local = cg_left & int(spec.numa_cg_masks[u])
        if local.bit_count() < need_cgs_per_gpu:
            return False
        # consume the local CoreGroups so two GPUs on one NUMA don't double count
        take = need_cgs_per_gpu
        for c in range(spec.num_coregroups):
            if take == 0:
                break
            if local >> c & 1:
                cg_left &= ~(1 << c)
                take -= 1
    return True


def is_topology_hit(spec: ServerSpec, gpu_mask: int, cg_mask: int,
                    need_gpus: int, need_cgs: int,
                    bundle_locality: bool = True) -> bool:
    """Paper Table 4 hit predicate: guaranteed NUMA bundles + best socket tier."""
    if need_gpus == 0:
        return True
    if bundle_locality and not bundle_locality_ok(
            spec, gpu_mask, cg_mask, need_cgs // need_gpus):
        return False
    return achieved_tier(spec, gpu_mask) <= min_tier_for(spec, need_gpus)
