"""Victim-selection engines (paper §3.4, Algorithm 2).

Three engines over the same Cluster state:

* ``godel_standard``       — the baseline re-implementation: per node, greedily
  evict lowest-priority victims until the preemptor *fits by resource count*
  (no topology), choose the node minimizing evicted priority.  This mirrors
  Gödel's standard preemption ("directly selects the first feasible set of
  victims for each node").
* ``flextopo_exhaustive``  — topology-aware, evaluates EVERY victim subset
  (O(2^m) per node) and applies Eq. 1/Eq. 2 scoring.  Upper bound on quality,
  used to validate IMP and to measure the paper's "without IMP" overhead.
* ``flextopo_imp``         — Incremental Minimal Preemption: evaluate subsets
  from size k=1 upward; stop at the smallest k with any feasible group
  (Algorithm 2).  Average-case ≈ polynomial.

Each engine returns per-node `Candidate`s; the Scheduler combines them with
Eq. 2 (`scoring.select_best`).
"""
from __future__ import annotations

import itertools
from typing import Iterable, Sequence

from .cluster import Cluster
from .engines import register_engine
from .placement import INFEASIBLE, best_tier
from .scoring import Candidate
from .workload import Instance, TopoPolicy, WorkloadSpec


def _request(workload: WorkloadSpec, coregroup_size: int) -> tuple[int, int, bool]:
    need_gpus = workload.gpus_per_instance
    need_cgs = workload.coregroups_per_instance(coregroup_size)
    bundle = workload.numa_policy == TopoPolicy.GUARANTEED
    return need_gpus, need_cgs, bundle


def _tier_after_evicting(
    cluster: Cluster,
    node: int,
    victims: Sequence[Instance],
    workload: WorkloadSpec,
) -> int:
    """Best achievable tier on `node` after hypothetically draining `victims`."""
    spec = cluster.spec
    free_gpu, free_cg = cluster.free_masks(node)
    for v in victims:
        free_gpu |= v.gpu_mask
        free_cg |= v.cg_mask
    need_gpus, need_cgs, bundle = _request(workload, spec.coregroup_size)
    return best_tier(spec, free_gpu, free_cg, need_gpus, need_cgs, bundle)


# ---------------------------------------------------------------------------------
# Baseline: Gödel standard preemption (priority-only, first feasible set)
# ---------------------------------------------------------------------------------

def godel_standard(cluster: Cluster, workload: WorkloadSpec, node: int
                   ) -> Candidate | None:
    spec = cluster.spec
    victims = cluster.victims_on(node, workload.priority)  # ascending priority
    free_gpu, free_cg = cluster.free_masks(node)
    need_gpus, need_cgs, _ = _request(workload, spec.coregroup_size)
    chosen: list[Instance] = []
    for v in victims:
        if (free_gpu.bit_count() >= need_gpus and free_cg.bit_count() >= need_cgs):
            break
        free_gpu |= v.gpu_mask
        free_cg |= v.cg_mask
        chosen.append(v)
    if free_gpu.bit_count() < need_gpus or free_cg.bit_count() < need_cgs:
        return None
    # tier recorded for accounting only; the baseline neither filters nor sorts on it
    tier = best_tier(spec, free_gpu, free_cg, need_gpus, need_cgs,
                     bundle_locality=False)
    return Candidate(
        node=node,
        victims=tuple(sorted(v.uid for v in chosen)),
        tier=tier if tier != INFEASIBLE else 2,
        priority_sum=sum(v.priority for v in chosen),
    )


def _godel_select(candidates: list[Candidate], alpha: float) -> Candidate | None:
    """Standard policy: minimize evicted priority, then victim count."""
    if not candidates:
        return None
    return min(candidates, key=lambda c: (c.priority_sum, len(c.victims), c.node))


@register_engine("godel", topology_aware=False, selector=_godel_select)
def godel_source(cluster: Cluster, workload: WorkloadSpec, node: int
                 ) -> list[Candidate]:
    c = godel_standard(cluster, workload, node)
    return [c] if c is not None else []


# ---------------------------------------------------------------------------------
# FlexTopo engines
# ---------------------------------------------------------------------------------

def _evaluate_combos(
    cluster: Cluster,
    node: int,
    workload: WorkloadSpec,
    combos: Iterable[tuple[Instance, ...]],
) -> list[Candidate]:
    out = []
    for combo in combos:
        tier = _tier_after_evicting(cluster, node, combo, workload)
        if tier != INFEASIBLE:
            out.append(
                Candidate(
                    node=node,
                    victims=tuple(sorted(v.uid for v in combo)),
                    tier=tier,
                    priority_sum=sum(v.priority for v in combo),
                )
            )
    return out


@register_engine("exhaustive")
def flextopo_exhaustive(cluster: Cluster, workload: WorkloadSpec, node: int
                        ) -> list[Candidate]:
    """All 2^m - 1 non-empty victim subsets (+ the empty set if it already fits)."""
    victims = cluster.victims_on(node, workload.priority)
    combos: list[tuple[Instance, ...]] = [()]
    for k in range(1, len(victims) + 1):
        combos.extend(itertools.combinations(victims, k))
    return _evaluate_combos(cluster, node, workload, combos)


def min_feasible_k(cluster: Cluster, workload: WorkloadSpec, node: int,
                   victims: Sequence[Instance]) -> int:
    """Counting lower bound on the subset size (the paper's 'quick failures'
    on small combinations, §5 Fig 10: an 8-GPU preemptor skips sizes that
    cannot possibly free enough devices).  Sizes below this bound are
    infeasible by resource count alone, so skipping them cannot change the
    result."""
    if not victims:
        return 0
    spec = cluster.spec
    free_gpu, free_cg = cluster.free_masks(node)
    need_gpus = workload.gpus_per_instance
    need_cgs = workload.coregroups_per_instance(spec.coregroup_size)
    max_g = max(v.gpu_mask.bit_count() for v in victims)
    max_c = max(v.cg_mask.bit_count() for v in victims)
    kg = 0 if free_gpu.bit_count() >= need_gpus else -(
        -(need_gpus - free_gpu.bit_count()) // max(max_g, 1))
    kc = 0 if free_cg.bit_count() >= need_cgs else -(
        -(need_cgs - free_cg.bit_count()) // max(max_c, 1))
    return max(kg, kc)


@register_engine("imp")
def flextopo_imp(cluster: Cluster, workload: WorkloadSpec, node: int
                 ) -> list[Candidate]:
    """Algorithm 2: smallest-subset-first with early stop (+ counting
    lower bound so hopeless sizes fail 'quickly', per the paper's Fig 10)."""
    victims = cluster.victims_on(node, workload.priority)
    k_min = min_feasible_k(cluster, workload, node, victims)
    if k_min == 0:
        feasible = _evaluate_combos(cluster, node, workload, [()])
        if feasible:
            return feasible
        k_min = 1
    for k in range(k_min, len(victims) + 1):
        feasible = _evaluate_combos(
            cluster, node, workload, itertools.combinations(victims, k)
        )
        if feasible:
            return feasible  # early stop: no benefit in evicting more pods
    return []


# ---------------------------------------------------------------------------------
# Oracle for property tests: smallest feasible subset size by definition
# ---------------------------------------------------------------------------------

def brute_force_min_k(cluster: Cluster, workload: WorkloadSpec, node: int
                      ) -> tuple[int, list[Candidate]] | None:
    """The smallest subset size k that frees a feasible placement on
    ``node`` and every feasible subset of that size, trying every size
    from 0 up with no bound or early exit; None when no subset is
    feasible."""
    victims = cluster.victims_on(node, workload.priority)
    for k in range(0, len(victims) + 1):
        combos = [()] if k == 0 else list(itertools.combinations(victims, k))
        feasible = _evaluate_combos(cluster, node, workload, combos)
        if feasible:
            return k, feasible
    return None
