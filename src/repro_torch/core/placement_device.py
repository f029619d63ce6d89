"""Device-side placement scorer (paper §3.4 Sorting + the normal cycle).

Counterpart of the reference's ``repro.core.placement_jax``: the host
``placement`` module walks NUMA nodes and bit-scans GPU/CoreGroup masks in
python; this module is its bitwise twin as vectorized int32 bit math on
torch tensors of any device, so both cycles of Algorithm 1 can run over the
resident `DeviceClusterState`:

* `best_tier_counts` / `tier_from_counts_dyn` — tier-0/1/2 bundle
  feasibility from per-NUMA popcounts of the free masks;
* `place_core` — the concrete GPU/CoreGroup mask selection of
  ``placement.place``: scope choice (per-NUMA → per-socket → global slices)
  by the same best-fit key, then lowest-free-bit allocation per NUMA in
  scope order;
* `place_blind_core` / `achieved_tier_dev` — ``placement.place_blind`` and
  the committed-tier accounting;
* `normal_cycle_core` — the whole ``TopoScheduler._plan_normal`` sweep: per
  node placement tier (with the kubelet degraded-admission blind fallback),
  the ``(tier, leftover, node)`` argmin, and the winner's masks;
* `winner_place` — freed-mask reconstruction + placement for a preemption
  winner.

These are plain PyTorch: the CPU path of the fused engine and the
yardstick of its kernels.  On the card, ``kernels.normal_cycle`` carries
`normal_cycle_core` and ``kernels.fused_class`` carries `winner_place`.

Host-callable wrappers (`device_best_tier`, `device_place`,
`device_place_blind`) exist for the host-vs-device parity tests.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .placement import INFEASIBLE, Placement
from .topology import ServerSpec

_INT32_MAX = 2**31 - 1


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 bit pattern (SWAR on int64 to stay unsigned)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _i32(values) -> torch.Tensor:
    """int32 bit patterns of Python/numpy integers (bit 31 wraps)."""
    return torch.from_numpy(np.asarray(values, np.int64).astype(np.int32))


@lru_cache(maxsize=None)
def spec_constants(spec: ServerSpec,
                   device: torch.device | str = "cpu") -> dict:
    """Per-NUMA masks and the socket one-hot of one SKU on ``device``."""
    sock_onehot = np.zeros((spec.num_numa, spec.num_sockets), dtype=np.int32)
    for u in range(spec.num_numa):
        sock_onehot[u, spec.socket_of_numa(u)] = 1
    return {
        "numa_gpu_masks": _i32(spec.numa_gpu_masks).to(device),
        "numa_cg_masks": _i32(spec.numa_cg_masks).to(device),
        "sock_onehot": torch.from_numpy(sock_onehot).to(device),
    }


@dataclasses.dataclass(frozen=True)
class SpecSlices:
    """Static NUMA/socket slice layout of one SKU.

    ``scope_mask [n_scopes, U]`` enumerates the placement scopes in the
    host's order — one row per NUMA node, one per socket, one global — and
    ``scope_tier [n_scopes]`` their tier; within a tier, ascending row index
    equals the host's numa-list order, so the best-fit argmin over
    ``(leftover, row)`` reproduces ``placement.place``'s scope choice.
    ``g_bits``/``g_prefix`` (and the CoreGroup twins) drive the vectorized
    lowest-k-set-bits selector."""

    numa_gpu: torch.Tensor      # int32[U]
    numa_cg: torch.Tensor       # int32[U]
    sock_onehot: torch.Tensor   # int32[U, S]
    scope_mask: torch.Tensor    # int32[n_scopes, U]
    scope_tier: torch.Tensor    # int32[n_scopes]
    g_bits: torch.Tensor        # int32[num_gpus]        1 << i
    g_prefix: torch.Tensor      # int32[num_gpus]        (1 << i) - 1
    c_bits: torch.Tensor        # int32[num_coregroups]
    c_prefix: torch.Tensor


@lru_cache(maxsize=None)
def spec_slices(spec: ServerSpec,
                device: torch.device | str = "cpu") -> SpecSlices:
    consts = spec_constants(spec, device)
    u_n, s_n = spec.num_numa, spec.num_sockets
    scopes = np.zeros((u_n + s_n + 1, u_n), np.int32)
    tiers = np.zeros(u_n + s_n + 1, np.int32)
    for u in range(u_n):
        scopes[u, u] = 1
    for s in range(s_n):
        for u in range(u_n):
            if spec.socket_of_numa(u) == s:
                scopes[u_n + s, u] = 1
        tiers[u_n + s] = 1
    scopes[-1, :] = 1
    tiers[-1] = 2

    def bits(n):
        one = np.int64(1) << np.arange(n, dtype=np.int64)
        return _i32(one).to(device), _i32(one - 1).to(device)

    g_bits, g_prefix = bits(spec.num_gpus)
    c_bits, c_prefix = bits(spec.num_coregroups)
    return SpecSlices(
        numa_gpu=consts["numa_gpu_masks"], numa_cg=consts["numa_cg_masks"],
        sock_onehot=consts["sock_onehot"],
        scope_mask=torch.from_numpy(scopes).to(device),
        scope_tier=torch.from_numpy(tiers).to(device),
        g_bits=g_bits, g_prefix=g_prefix, c_bits=c_bits, c_prefix=c_prefix)


def _dot_last(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``x @ mat`` over the last axis for int32 tensors (sum of products)."""
    return (x[..., :, None] * mat).sum(dim=-2, dtype=torch.int32)


def tier_from_counts_dyn(cnt_gpu, cnt_cg, sock_onehot,
                         need_gpus: int, need_cgs: int, cgs_per_bundle: int):
    """Placement tier from per-NUMA availability counts ``[..., U]``.

    ``cgs_per_bundle`` = 0 encodes both "no bundle locality" and CPU-only
    asks (with ``need_gpus`` = 0 the GPU-unit comparisons are trivially
    true, leaving exactly the host's CoreGroup-only conditions)."""
    if cgs_per_bundle > 0:
        units = torch.minimum(cnt_gpu, cnt_cg // cgs_per_bundle)
    else:
        units = cnt_gpu
    numa_ok = ((units >= need_gpus) & (cnt_cg >= need_cgs)).any(dim=-1)
    sock_units = _dot_last(units, sock_onehot)
    sock_cg = _dot_last(cnt_cg, sock_onehot)
    sock_ok = ((sock_units >= need_gpus) & (sock_cg >= need_cgs)).any(dim=-1)
    glob_ok = (units.sum(dim=-1) >= need_gpus) & (
        cnt_cg.sum(dim=-1) >= need_cgs)
    return torch.where(numa_ok, 0, torch.where(
        sock_ok, 1, torch.where(glob_ok, 2, 3))).to(torch.int32)


def _lowest_bits_dev(mask, k, bits, prefix):
    """Lowest ``k`` set bits of ``mask`` (broadcasts over leading axes).

    Bit i is selected iff it is set and fewer than ``k`` set bits lie below
    it; when ``mask`` holds fewer than ``k`` bits every set bit is taken
    (callers' remaining-count checks flag the shortfall)."""
    mask = mask[..., None]
    below = popcount32(mask & prefix)
    k = torch.as_tensor(k, dtype=torch.int32, device=mask.device)
    sel = ((mask & bits) != 0) & (below < k[..., None])
    return torch.where(sel, bits, 0).sum(dim=-1, dtype=torch.int32)


def achieved_tier_dev(gpu_mask, sl: SpecSlices):
    """``placement.achieved_tier`` (broadcasts over leading axes)."""
    touched = (gpu_mask[..., None] & sl.numa_gpu) != 0          # [..., U]
    n_numa = touched.sum(dim=-1)
    n_sock = (_dot_last(touched.to(torch.int32), sl.sock_onehot) > 0).sum(
        dim=-1)
    return torch.where(gpu_mask == 0, 0, torch.where(
        n_numa <= 1, 0, torch.where(n_sock <= 1, 1, 2))).to(torch.int32)


def best_tier_counts(free_gpu, free_cg, ng: int, nc: int, cpb: int,
                     sl: SpecSlices):
    """Per-NUMA popcounts + tier for free masks of any leading shape."""
    cnt_g = popcount32(free_gpu[..., None] & sl.numa_gpu)
    cnt_c = popcount32(free_cg[..., None] & sl.numa_cg)
    tier = tier_from_counts_dyn(cnt_g, cnt_c, sl.sock_onehot, ng, nc, cpb)
    return tier, cnt_g, cnt_c


def place_core(free_gpu, free_cg, ng: int, nc: int, cpb: int, *,
               spec: ServerSpec):
    """``placement.place`` as bit math (broadcasts over leading axes).

    Returns ``(ok bool, tier int32, gpu_mask int32, cg_mask int32)``,
    bitwise-matching the host: same best-fit scope choice (least leftover
    bundle capacity, then lowest scope), same lowest-free-bit allocation per
    NUMA in scope index order, same leftover-CoreGroup sweep.
    """
    sl = spec_slices(spec, free_gpu.device)
    tier, cnt_g, cnt_c = best_tier_counts(free_gpu, free_cg, ng, nc, cpb, sl)
    units_u = torch.minimum(cnt_g, cnt_c // cpb) if cpb > 0 else cnt_g
    s_units = (units_u[..., None, :] * sl.scope_mask).sum(-1, dtype=torch.int32)
    s_cg = (cnt_c[..., None, :] * sl.scope_mask).sum(-1, dtype=torch.int32)
    feas = (s_units >= ng) & (s_cg >= nc) & (sl.scope_tier
                                             == tier[..., None])
    n_scopes = sl.scope_mask.shape[0]
    order = torch.arange(n_scopes, dtype=torch.int32, device=free_gpu.device)
    key = torch.where(feas, (s_units - ng) * n_scopes + order, _INT32_MAX)
    member = sl.scope_mask[torch.argmin(key, dim=-1)]           # [..., U]
    ok = (tier < 3) & feas.any(dim=-1)

    gpu_mask = torch.zeros_like(free_gpu)
    cg_mask = torch.zeros_like(free_cg)
    rem_g = torch.full_like(free_gpu, ng)
    rem_c = torch.full_like(free_cg, nc)
    for u in range(spec.num_numa):       # NUMA nodes in scope index order
        u_free_g = free_gpu & sl.numa_gpu[u]
        u_free_c = free_cg & sl.numa_cg[u]
        take = torch.minimum(rem_g, units_u[..., u]) * member[..., u]
        gpu_mask = gpu_mask | _lowest_bits_dev(u_free_g, take, sl.g_bits,
                                               sl.g_prefix)
        rem_g = rem_g - take
        c_take = torch.minimum(take * cpb, rem_c)
        cg_mask = cg_mask | _lowest_bits_dev(u_free_c, c_take, sl.c_bits,
                                             sl.c_prefix)
        rem_c = rem_c - c_take
    for u in range(spec.num_numa):       # leftover CoreGroups, scope order
        avail = free_cg & sl.numa_cg[u] & ~cg_mask
        take = torch.minimum(popcount32(avail), rem_c) * member[..., u]
        cg_mask = cg_mask | _lowest_bits_dev(avail, take, sl.c_bits,
                                             sl.c_prefix)
        rem_c = rem_c - take
    ok = ok & (rem_g == 0) & (rem_c == 0)
    return ok, tier, gpu_mask, cg_mask


def place_blind_core(free_gpu, free_cg, ng: int, nc: int, *,
                     spec: ServerSpec):
    """``placement.place_blind`` (broadcasts over leading axes)."""
    sl = spec_slices(spec, free_gpu.device)
    ok = (popcount32(free_gpu) >= ng) & (popcount32(free_cg) >= nc)
    gpu_mask = _lowest_bits_dev(free_gpu, torch.full_like(free_gpu, ng),
                                sl.g_bits, sl.g_prefix)
    cg_mask = _lowest_bits_dev(free_cg, torch.full_like(free_cg, nc),
                               sl.c_bits, sl.c_prefix)
    return ok, achieved_tier_dev(gpu_mask, sl), gpu_mask, cg_mask


def normal_cycle_core(nodestate, ng: int, nc: int, cpb: int, *,
                      spec: ServerSpec) -> torch.Tensor:
    """``TopoScheduler._plan_normal`` as one sweep over ``nodestate``.

    Per node: count pre-screen, placement tier (topology-feasible nodes
    place at ``best_tier``; count-feasible but topology-infeasible nodes
    admit DEGRADED via the blind allocator at its achieved tier), then the
    host's exact ``(tier, leftover, node)`` argmin and the winner's masks.
    Rows with node id = `IDX_SENTINEL` never win.

    Returns int32[5]: (found, node, tier, gpu_mask, cg_mask).
    """
    from .cluster import NS_FREE_CG, NS_FREE_GPU, NS_NODE_ID

    sl = spec_slices(spec, nodestate.device)
    free_g = nodestate[NS_FREE_GPU]
    free_c = nodestate[NS_FREE_CG]
    node_ids = nodestate[NS_NODE_ID]
    cnt_g = popcount32(free_g)
    cnt_ok = (cnt_g >= ng) & (popcount32(free_c) >= nc) & (
        node_ids < _INT32_MAX)
    tier, _, _ = best_tier_counts(free_g, free_c, ng, nc, cpb, sl)
    placeable = tier < 3
    _, b_tier, b_g, b_c = place_blind_core(free_g, free_c, ng, nc, spec=spec)
    eff_tier = torch.where(placeable, tier, b_tier)
    leftover = cnt_g - ng
    big = _INT32_MAX
    t = torch.where(cnt_ok, eff_tier, big)
    sel = cnt_ok & (eff_tier == t.min())
    lo = torch.where(sel, leftover, big)
    sel = sel & (leftover == lo.min())
    row = torch.argmin(torch.where(sel, node_ids, big))
    found = cnt_ok.any()
    p_ok, p_tier, p_g, p_c = place_core(free_g[row], free_c[row], ng, nc,
                                        cpb, spec=spec)
    use_place = placeable[row] & p_ok
    return torch.stack([
        found.to(torch.int32),
        node_ids[row],
        torch.where(use_place, p_tier, b_tier[row]),
        torch.where(use_place, p_g, b_g[row]),
        torch.where(use_place, p_c, b_c[row]),
    ]).to(torch.int32)


def winner_place(win, free_gpu, free_cg, victim_gpu, victim_cg,
                 ng: int, nc: int, cpb: int, *, spec: ServerSpec):
    """Placement masks for a preemption winner.

    ``win`` is the int32[7] Eq. 2 argmax vector (found, row, tier,
    combo_id, prio_sum, k, n_candidates); the winner's freed masks are its
    row's free masks OR its combo's victim masks (victim masks of one node
    are disjoint, so this OR is the reference's sum) and are placed with
    `place_core`.  Returns int32[9]: ``win`` + (gpu_mask, cg_mask).
    """
    row = win[1].to(torch.int64)
    combo = win[3]
    cap = victim_gpu.shape[-1]
    slots = torch.arange(cap, dtype=torch.int32, device=win.device)
    bits = ((combo >> slots) & 1) != 0
    freed_g = free_gpu[row] | torch.where(bits, victim_gpu[row], 0).sum(
        dtype=torch.int32)
    freed_c = free_cg[row] | torch.where(bits, victim_cg[row], 0).sum(
        dtype=torch.int32)
    _, _, p_g, p_c = place_core(freed_g, freed_c, ng, nc, cpb, spec=spec)
    return torch.cat([win, torch.stack([p_g, p_c]).to(torch.int32)])


# ---------------------------------------------------------------------------------
# Host-callable wrappers (parity oracle surface for the tests)
# ---------------------------------------------------------------------------------

def _req_of(need_gpus: int, need_cgs: int,
            bundle_locality: bool) -> tuple[int, int, int]:
    cpb = need_cgs // need_gpus if (bundle_locality and need_gpus) else 0
    return need_gpus, need_cgs, cpb


def _masks(free_gpu: int, free_cg: int, device) -> tuple:
    x = _i32([free_gpu, free_cg]).to(device)
    return x[0], x[1]


def device_best_tier(spec: ServerSpec, free_gpu: int, free_cg: int,
                     need_gpus: int, need_cgs: int,
                     bundle_locality: bool = True,
                     device: str = "cuda") -> int:
    """Host-callable `best_tier` twin (returns `placement.INFEASIBLE`=3)."""
    g, c = _masks(free_gpu, free_cg, device)
    tier, _, _ = best_tier_counts(
        g, c, *_req_of(need_gpus, need_cgs, bundle_locality),
        spec_slices(spec, g.device))
    return int(tier)


def _decode(ok, tier, g, c, need_feasible_tier: bool) -> Placement | None:
    ok, tier, g, c = (int(x) for x in (ok, tier, g, c))
    if not ok or (need_feasible_tier and tier >= INFEASIBLE):
        return None
    return Placement(gpu_mask=g & 0xFFFFFFFF, cg_mask=c & 0xFFFFFFFF,
                     tier=tier)


def device_place(spec: ServerSpec, free_gpu: int, free_cg: int,
                 need_gpus: int, need_cgs: int,
                 bundle_locality: bool = True,
                 device: str = "cuda") -> Placement | None:
    """Host-callable `place` twin (bitwise-identical masks)."""
    g, c = _masks(free_gpu, free_cg, device)
    return _decode(*place_core(
        g, c, *_req_of(need_gpus, need_cgs, bundle_locality), spec=spec),
        need_feasible_tier=True)


def device_place_blind(spec: ServerSpec, free_gpu: int, free_cg: int,
                       need_gpus: int, need_cgs: int,
                       device: str = "cuda") -> Placement | None:
    """Host-callable `place_blind` twin."""
    g, c = _masks(free_gpu, free_cg, device)
    return _decode(*place_blind_core(g, c, need_gpus, need_cgs, spec=spec),
                   need_feasible_tier=False)
