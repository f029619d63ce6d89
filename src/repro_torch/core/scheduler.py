"""Topology-aware scheduler (paper §3.1, Algorithm 1) — transactional API.

Pipeline per scheduling attempt:

1. **Normal cycle** — place the instance on a node with free resources,
   topology-aware (tier-minimizing) for FlexTopo modes, lowest-index blind for
   the baseline mode.
2. **Preemption** (only if the normal cycle fails):
   * *Guaranteed Filtering* — keep candidate nodes that could satisfy the
     preemptor's topology policy if ALL their victims were drained.
   * *Best-effort Sorting* — source victim-set candidates with the
     configured engine ({engines}), then select the global argmax of
     Eq. 1/Eq. 2.
   * *Bind* — evict the victims and place the preemptor.

The normal cycle and Filtering are python loops over the nodes and Sorting
is sourced per node by the engine.  With ``engine="imp_pallas"`` Sorting
scores every victim subset of a filtered node in one CUDA kernel launch on
the cluster's device (`repro_torch.kernels.topo_score`).

Transactional protocol
----------------------
``plan(workload)`` runs Filtering → Sorting against a copy-on-write
`ClusterView` and returns a `Transaction` holding a unified
`SchedulingDecision` (kind ∈ placed | preempted | rejected).  Nothing is
mutated until ``txn.commit()``; dropping or ``rollback()``-ing a planned
transaction is free, which makes the Table 4 "independent preemptions"
protocol a pure read.  ``plan_batch([...])`` plans several pending
preemptors against one shared view so the decisions compose.
``schedule`` / ``preempt`` / ``schedule_or_preempt`` are plan-and-commit
conveniences, and the deprecated ``undo(decision)`` shim delegates to
``Transaction.rollback()``.

Latency accounting mirrors the paper's overhead analysis: we time the
candidate-sourcing phase ("the primary contributor to time overhead").
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Iterable

from . import preemption  # noqa: F401  (self-register the host engines)
from .cluster import Cluster, ClusterView
from .decisions import SchedulingDecision, Transaction
from .engines import (EngineName, SourcingEngine, UnknownEngineError,
                      get_engine, registered_engines)
from .placement import (INFEASIBLE, Placement, best_tier, is_topology_hit,
                        place, place_blind)
from .scoring import DEFAULT_ALPHA
from .workload import TopoPolicy, WorkloadSpec

@dataclasses.dataclass(frozen=True)
class ShortlistConfig:
    """Knobs of the two-stage shortlist sourcing front-end.

    ``k`` is the number of representative rows the stage-1 prescreen keeps
    for the exact stage-2 subset sweep.  ``mode``:

    * ``"guaranteed"`` — bit-identical decisions to the full sweep: the
      prescreen bound is admissible, and whenever the certainty check
      cannot PROVE the winner beats every excluded row's upper bound, the
      caller re-dispatches the full sweep.
    * ``"best_effort"`` — fixed-K latency cap: the shortlist winner is
      returned even when uncertain.

    No engine of this package takes it yet: the fused engine that does is
    still to be ported.
    """

    k: int = 128
    mode: str = "guaranteed"

    def __post_init__(self) -> None:
        if self.k <= 0:
            raise ValueError(f"shortlist k must be positive, got {self.k}")
        if self.mode not in ("guaranteed", "best_effort"):
            raise ValueError(f"unknown shortlist mode {self.mode!r}")


class TopoScheduler:
    """Algorithm 1 scheduler over a pluggable sourcing engine (module
    docstring above for the pipeline).

    Engine selection: pass a registered engine name.  ``engine="auto"``
    routes by cluster size to ``imp_batched`` / ``imp_sharded`` in the
    reference; neither is ported yet, so it raises `UnknownEngineError`
    rather than pick another engine.
    """

    def __init__(
        self,
        cluster: Cluster,
        engine: EngineName = "imp",
        alpha: float = DEFAULT_ALPHA,
        topology_aware_placement: bool | None = None,
    ) -> None:
        if engine == "auto":
            raise UnknownEngineError(engine)
        self.cluster = cluster
        self.engine: EngineName = engine
        self._engine: SourcingEngine = get_engine(engine)
        self.alpha = alpha
        # Local (node-internal) allocation is kubelet-style topology-aware for
        # ALL engines — the paper's baseline miss comes from topology-blind
        # victim/node selection freeing badly-distributed resources, not from
        # a dumb local allocator.  Pass False explicitly for the blind-allocator
        # ablation.
        self.topology_aware = (
            True if topology_aware_placement is None else topology_aware_placement
        )
        self.sourcing_us_log: list[float] = []
        self.listeners: list[Callable[[SchedulingDecision, str], None]] = []

    # ---- commit/rollback observers ------------------------------------------------
    def add_listener(self, fn: Callable[[SchedulingDecision, str], None]) -> None:
        """Subscribe to committed/rolled-back decisions (e.g. the agent fleet)."""
        self.listeners.append(fn)

    def remove_listener(self, fn: Callable[[SchedulingDecision, str], None]) -> None:
        """Unsubscribe a decision listener (missing listeners are a no-op)."""
        try:
            self.listeners.remove(fn)
        except ValueError:
            pass

    def _notify(self, decision: SchedulingDecision, event: str) -> None:
        for fn in self.listeners:
            fn(decision, event)

    # ---- request helpers -------------------------------------------------------
    def _request(self, workload: WorkloadSpec) -> tuple[int, int, bool]:
        spec = self.cluster.spec
        return (
            workload.gpus_per_instance,
            workload.coregroups_per_instance(spec.coregroup_size),
            workload.numa_policy == TopoPolicy.GUARANTEED,
        )

    def _place_on(self, workload: WorkloadSpec, node: int,
                  view: ClusterView) -> Placement | None:
        spec = self.cluster.spec
        free_gpu, free_cg = view.free_masks(node)
        need_gpus, need_cgs, bundle = self._request(workload)
        if self.topology_aware:
            p = place(spec, free_gpu, free_cg, need_gpus, need_cgs, bundle)
            if p is not None:
                return p
            # kubelet best-effort admission: resources fit by count but not by
            # topology — admit degraded (this is the paper's
            # TopologyAffinityError / degraded-performance case, counted as a
            # miss).  FlexTopo engines never reach this branch because their
            # candidates are topology-feasible by construction.
            return place_blind(spec, free_gpu, free_cg, need_gpus, need_cgs)
        return place_blind(spec, free_gpu, free_cg, need_gpus, need_cgs)

    def _hit(self, workload: WorkloadSpec, placement: Placement) -> bool:
        need_gpus, need_cgs, bundle = self._request(workload)
        return is_topology_hit(self.cluster.spec, placement.gpu_mask,
                               placement.cg_mask, need_gpus, need_cgs, bundle)

    # ---- planning: normal scheduling cycle ----------------------------------------
    def _plan_normal(self, workload: WorkloadSpec,
                     view: ClusterView) -> tuple[int, Placement] | None:
        best: tuple[tuple, int, Placement] | None = None
        need_gpus, need_cgs, _ = self._request(workload)
        for node in range(view.num_nodes):
            free_gpu, free_cg = view.free_masks(node)
            # count pre-screen: placement (topology-aware or blind) can
            # never succeed without enough free bits — skips the expensive
            # per-node placement construction on saturated clusters
            if (free_gpu.bit_count() < need_gpus
                    or free_cg.bit_count() < need_cgs):
                continue
            p = self._place_on(workload, node, view)
            if p is None:
                continue
            if not self._engine.topology_aware:
                # default scheduler: first node that fits
                best = ((0,), node, p)
                break
            free_gpu, _ = view.free_masks(node)
            leftover = free_gpu.bit_count() - workload.gpus_per_instance
            key = (p.tier, leftover, node)   # best tier, then best-fit
            if best is None or key < best[0]:
                best = (key, node, p)
        if best is None:
            return None
        _, node, placement = best
        return node, placement

    # ---- planning: preemption ------------------------------------------------------
    def _guaranteed_filter(self, workload: WorkloadSpec,
                           view: ClusterView) -> list[int]:
        """Alg. 1 Filtering: nodes feasible under hypothetical full drain."""
        spec = self.cluster.spec
        need_gpus, need_cgs, bundle = self._request(workload)
        nodes = []
        for node in range(view.num_nodes):
            free_gpu, free_cg = view.free_masks(node)
            for v in view.victims_on(node, workload.priority):
                free_gpu |= v.gpu_mask
                free_cg |= v.cg_mask
            if not self._engine.topology_aware:
                ok = (free_gpu.bit_count() >= need_gpus
                      and free_cg.bit_count() >= need_cgs)
            elif workload.numa_policy == TopoPolicy.GUARANTEED:
                ok = best_tier(spec, free_gpu, free_cg, need_gpus, need_cgs,
                               bundle) != INFEASIBLE
            else:  # best-effort QoS: no topology constraint during Filtering
                ok = (free_gpu.bit_count() >= need_gpus
                      and free_cg.bit_count() >= need_cgs)
            if ok:
                nodes.append(node)
        return nodes

    def _plan_preempt(self, workload: WorkloadSpec, view: ClusterView
                      ) -> tuple[SchedulingDecision, int | None]:
        nodes = self._guaranteed_filter(workload, view)
        if not nodes:
            return SchedulingDecision(kind="rejected", workload=workload), None
        t0 = time.perf_counter()
        candidates = self._engine.source_all(view, workload, nodes)
        sourcing_us = (time.perf_counter() - t0) * 1e6
        self.sourcing_us_log.append(sourcing_us)
        if not candidates:
            return SchedulingDecision(kind="rejected", workload=workload,
                                      sourcing_us=sourcing_us), None
        chosen = self._engine.select(candidates, self.alpha)
        return self._bind_preemption(
            workload, view, chosen.node, chosen.victims, sourcing_us,
            len(candidates))

    def _bind_preemption(
        self, workload: WorkloadSpec, view: ClusterView, node: int,
        victims: tuple[int, ...], sourcing_us: float, num_candidates: int,
    ) -> tuple[SchedulingDecision, int | None]:
        """Preemption tail: plan the evictions, place, and bind."""
        for uid in victims:
            view.plan_evict(uid)
        placement = self._place_on(workload, node, view)
        if placement is None:  # cannot happen if engines are correct
            raise RuntimeError("victim set freed insufficient resources")
        planned = view.plan_bind(workload, node, placement)
        return SchedulingDecision(
            kind="preempted", workload=workload, node=node,
            placement=placement, hit=self._hit(workload, placement),
            victims=tuple(victims), sourcing_us=sourcing_us,
            num_candidates=num_candidates,
        ), planned.uid

    # ---- the transactional entry points --------------------------------------------
    def plan(self, workload: WorkloadSpec, *, view: ClusterView | None = None,
             allow_normal: bool = True,
             allow_preempt: bool = True) -> Transaction:
        """Evaluate one request Filtering → Sorting without mutating the cluster.

        Returns a `Transaction` whose ``decision`` is fully evaluated (node,
        placement, victims, topology hit, sourcing latency).  Call
        ``commit()`` to bind it for real, or drop/``rollback()`` it for a
        free independent evaluation.  Pass a shared ``view`` to compose
        several plans against one snapshot (see ``plan_batch``).
        """
        view = view if view is not None else ClusterView(self.cluster)
        decision: SchedulingDecision | None = None
        planned_uid: int | None = None
        if allow_normal:
            normal = self._plan_normal(workload, view)
            if normal is not None:
                node, placement = normal
                planned_uid = view.plan_bind(workload, node, placement).uid
                decision = SchedulingDecision(
                    kind="placed", workload=workload, node=node,
                    placement=placement,
                    hit=self._hit(workload, placement),
                )
        if decision is None and allow_preempt:
            decision, planned_uid = self._plan_preempt(workload, view)
        if decision is None:
            decision = SchedulingDecision(kind="rejected", workload=workload)
        return Transaction(cluster=self.cluster, decision=decision,
                           on_event=self._notify, view=view,
                           planned_uid=planned_uid)

    def plan_batch(self, workloads: Iterable[WorkloadSpec],
                   allow_preempt: bool = True) -> list[Transaction]:
        """Plan several pending requests against ONE cluster snapshot.

        All plans share a copy-on-write view: request *i+1* sees request
        *i*'s planned evictions and binds, so the returned transactions can
        be committed together in order.
        """
        view = ClusterView(self.cluster)
        return [self.plan(wl, view=view, allow_preempt=allow_preempt)
                for wl in workloads]

    # ---- plan-and-commit conveniences ----------------------------------------------
    def schedule(self, workload: WorkloadSpec) -> SchedulingDecision:
        """Normal cycle only; commits immediately (kind placed | rejected)."""
        return self.plan(workload, allow_preempt=False).commit()

    def preempt(self, workload: WorkloadSpec) -> SchedulingDecision:
        """Preemption only; commits immediately (kind preempted | rejected)."""
        return self.plan(workload, allow_normal=False).commit()

    def schedule_or_preempt(self, workload: WorkloadSpec) -> SchedulingDecision:
        """Full Algorithm 1; commits immediately."""
        return self.plan(workload).commit()

    # ---- undo (compat shim over Transaction.rollback) -------------------------------
    def undo(self, decision: SchedulingDecision) -> None:
        """Reverse a committed decision.

        .. deprecated:: read ``plan()`` decisions without committing, or
           call ``decision.txn.rollback()`` directly; this shim delegates to
           `Transaction.rollback`, which restores every victim with its
           original uid and full placement.
        """
        warnings.warn(
            "TopoScheduler.undo() is deprecated; use Transaction.rollback() "
            "(decision.txn.rollback()) or read plan() decisions without "
            "committing", DeprecationWarning, stacklevel=2)
        if decision.txn is None:
            raise ValueError("decision has no transaction to roll back")
        decision.txn.rollback()


if __doc__ is not None:  # None under python -OO (docstrings stripped)
    __doc__ = __doc__.format(engines=" | ".join(registered_engines()))
