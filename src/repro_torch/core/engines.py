"""Pluggable candidate-sourcing engine registry (scheduler Sorting phase).

A *sourcing engine* implements the Best-effort Sorting step of Algorithm 1:
given the cluster state, a preemptor workload, and the Filtering survivors,
produce the `Candidate` (node, victim-set) evaluations that Eq. 2 selects
over.  Engines register themselves by name::

    @register_engine("my_engine")
    def my_source(cluster, workload, node) -> list[Candidate]: ...

and the scheduler resolves them with ``get_engine(name)``.  Cluster-wide
engines (one sweep over ALL candidate nodes, e.g. the fused
``imp_batched``) register with ``batched=True`` and receive the full node
list; per-node engines are looped by the default ``source_all``.

Engines that live in modules outside the core import graph (the CUDA
kernels' ``imp_pallas``, the fused ``imp_batched``) register *lazily*:
``get_engine`` imports the owning module on first use and the module's
decorators complete the registration.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Protocol, runtime_checkable

from .scoring import Candidate, select_best

#: Backwards-compatible name for the engine identifier.  Engine names are now
#: open-ended registry keys rather than a closed Literal; the canonical list
#: is ``registered_engines()``.
EngineName = str


@runtime_checkable
class SourcingEngine(Protocol):
    """Protocol every registered engine satisfies.

    ``topology_aware=False`` marks baseline engines (Gödel-standard): the
    scheduler then filters by resource count only, scans nodes first-fit in
    the normal cycle, and selects candidates with ``select`` instead of the
    Eq. 2 argmax.
    """

    name: str
    topology_aware: bool

    def source(self, cluster, workload, node: int) -> list[Candidate]:
        """Candidates for one node."""
        ...

    def source_all(self, cluster, workload, nodes: list[int],
                   alpha: float | None = None) -> list[Candidate]:
        """Candidates for all filtered nodes (batched engines do one sweep).

        ``alpha`` is the scheduler's Eq. 1 weight; *fused* engines that run
        the Eq. 2 selection on the device (``imp_batched``) consume it
        during sourcing and return only the winning shortlist.
        """
        ...

    def select(self, candidates: list[Candidate], alpha: float) -> Candidate | None:
        """Pick the winning candidate (Eq. 2 unless the engine overrides)."""
        ...


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Function-backed `SourcingEngine` built by ``register_engine``."""

    name: str
    source_node: Callable | None = None     # fn(cluster, workload, node)
    source_nodes: Callable | None = None    # fn(cluster, workload, nodes)
    topology_aware: bool = True
    selector: Callable | None = None        # fn(candidates, alpha) -> Candidate
    needs_alpha: bool = False               # source_nodes takes alpha= (fused)
    #: the engine runs Guaranteed Filtering inside its own dispatch: the
    #: scheduler skips the host filter loop and calls ``source_all`` with
    #: ``nodes=None`` (evaluate the whole cluster)
    fused_filter: bool = False
    #: the engine runs BOTH cycles of Algorithm 1 — the normal cycle and
    #: §3.4 placement included — inside its dispatch: the scheduler calls
    #: ``plan_fused`` instead of its host ``_plan_normal``/``_place_on``
    #: loops and binds the decoded masks directly
    fused_place: bool = False
    #: fn(cluster_or_view, workload, alpha, allow_preempt) -> FusedPlanResult
    plan_fn: Callable | None = None
    #: fn(cluster_or_view, workload) -> (node, Placement) | None — the
    #: normal cycle alone as one dispatch
    normal_fn: Callable | None = None
    #: fn(cluster, workloads, alpha) -> batch-sourcing session for
    #: ``plan_batch`` (the class data of every request against one
    #: snapshot); its ``plan``/``source(view, workload, i)`` replace
    #: ``plan_fused``/``source_all`` for request i
    batch_factory: Callable | None = None
    #: fn(cluster, alpha): build kernels and fill caches at
    #: ``TopoScheduler(..., warmup=True)`` construction
    warmup_fn: Callable | None = None
    #: the engine's ``plan_fn``/``source_nodes``/``warmup_fn`` take a
    #: ``shortlist=`` `scheduler.ShortlistConfig`: the two-stage
    #: equivalence-class + top-K front-end.  Full-sweep oracle
    #: registrations (``*_full``) share the functions with the flag off.
    supports_shortlist: bool = False

    def source(self, cluster, workload, node: int) -> list[Candidate]:
        if self.source_node is not None:
            return list(self.source_node(cluster, workload, node))
        return self.source_all(cluster, workload, [node])

    def start_batch(self, cluster, workloads, alpha: float):
        """A batch-sourcing session for ``plan_batch``, or None."""
        if self.batch_factory is None:
            return None
        return self.batch_factory(cluster, workloads, alpha)

    def plan_fused(self, cluster, workload, alpha: float,
                   allow_preempt: bool = True, shortlist=None):
        """Both Algorithm 1 cycles in one dispatch (``fused_place``)."""
        if self.supports_shortlist and shortlist is not None:
            return self.plan_fn(cluster, workload, alpha, allow_preempt,
                                shortlist=shortlist)
        return self.plan_fn(cluster, workload, alpha, allow_preempt)

    def plan_normal(self, cluster, workload):
        """The normal cycle alone as one dispatch."""
        return self.normal_fn(cluster, workload)

    def warmup(self, cluster, alpha: float, shortlist=None) -> None:
        """Build kernels and fill caches (no-op without ``warmup_fn``)."""
        if self.warmup_fn is None:
            return
        if self.supports_shortlist and shortlist is not None:
            self.warmup_fn(cluster, alpha, shortlist=shortlist)
        else:
            self.warmup_fn(cluster, alpha)

    def source_all(self, cluster, workload, nodes: list[int] | None,
                   alpha: float | None = None,
                   shortlist=None) -> list[Candidate]:
        if self.source_nodes is not None:
            kw = {}
            if self.needs_alpha and alpha is not None:
                kw["alpha"] = alpha
            if self.supports_shortlist and shortlist is not None:
                kw["shortlist"] = shortlist
            got = self.source_nodes(cluster, workload, nodes, **kw)
            # keep list subclasses intact (CandidateShortlist.n_candidates)
            return got if isinstance(got, list) else list(got)
        out: list[Candidate] = []
        for node in nodes:
            out.extend(self.source_node(cluster, workload, node))
        return out

    def select(self, candidates: list[Candidate], alpha: float) -> Candidate | None:
        if self.selector is not None:
            return self.selector(candidates, alpha)
        return select_best(candidates, alpha)


class UnknownEngineError(ValueError):
    """Raised for unregistered engine names; lists what IS registered."""

    def __init__(self, name: str) -> None:
        self.name = name
        super().__init__(
            f"unknown scheduling engine {name!r}; registered engines: "
            f"{', '.join(registered_engines())}"
        )


_REGISTRY: dict[str, SourcingEngine] = {}

# name -> module that self-registers it on import (kept out of the eager
# import graph: the kernel modules own the CUDA builds and their wrappers).
_LAZY: dict[str, str] = {
    "imp_pallas": "repro_torch.kernels.topo_score",
    "imp_batched": "repro_torch.core.preemption_device",
    "imp_batched_full": "repro_torch.core.preemption_device",
    "imp_batched_legacy": "repro_torch.core.preemption_device",
    "imp_jax": "repro_torch.core.preemption_device",
    "imp_sharded": "repro_torch.core.cluster_parallel",
    "imp_sharded_full": "repro_torch.core.cluster_parallel",
}


def register_engine(
    name: str,
    *,
    batched: bool = False,
    topology_aware: bool = True,
    selector: Callable | None = None,
    needs_alpha: bool = False,
    fused_filter: bool = False,
    fused_place: bool = False,
    plan_fn: Callable | None = None,
    normal_fn: Callable | None = None,
    batch_factory: Callable | None = None,
    warmup_fn: Callable | None = None,
    supports_shortlist: bool = False,
):
    """Decorator: register a sourcing function.

    Plain functions take ``(cluster, workload, node)`` — or ``(cluster,
    workload, nodes)`` with ``batched=True`` — and return `Candidate`
    lists; ``selector`` replaces the Eq. 2 argmax.  ``needs_alpha=True``
    marks a batched function whose signature ends in ``alpha=`` because it
    fuses the Eq. 2 selection into sourcing.  ``fused_filter=True`` also
    fuses Guaranteed Filtering: the scheduler passes ``nodes=None``.
    ``fused_place=True`` (with ``plan_fn``/``normal_fn``) runs both
    Algorithm 1 cycles, placement masks included, inside the engine's
    dispatch.  ``batch_factory`` makes ``plan_batch``'s session (see
    `EngineSpec`), ``warmup_fn`` is the opt-in build/cache warm-up, and
    ``supports_shortlist`` marks functions that take ``shortlist=``.
    """

    def deco(fn):
        _REGISTRY[name] = EngineSpec(
            name=name,
            source_node=None if batched else fn,
            source_nodes=fn if batched else None,
            topology_aware=topology_aware, selector=selector,
            needs_alpha=needs_alpha, fused_filter=fused_filter,
            fused_place=fused_place, plan_fn=plan_fn, normal_fn=normal_fn,
            batch_factory=batch_factory, warmup_fn=warmup_fn,
            supports_shortlist=supports_shortlist)
        _LAZY.pop(name, None)
        return fn

    return deco


def get_engine(name: str) -> SourcingEngine:
    """Resolve an engine by name, importing lazy providers on first use."""
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name])  # module self-registers
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownEngineError(name) from None


def registered_engines() -> tuple[str, ...]:
    """All resolvable engine names (eager and lazy), sorted."""
    return tuple(sorted(set(_REGISTRY) | set(_LAZY)))
