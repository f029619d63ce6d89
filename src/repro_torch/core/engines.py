"""Pluggable candidate-sourcing engine registry (scheduler Sorting phase).

A *sourcing engine* implements the Best-effort Sorting step of Algorithm 1:
given the cluster state, a preemptor workload, and the Filtering survivors,
produce the `Candidate` (node, victim-set) evaluations that Eq. 2 selects
over.  Engines register themselves by name::

    @register_engine("my_engine")
    def my_source(cluster, workload, node) -> list[Candidate]: ...

and the scheduler resolves them with ``get_engine(name)``; ``source_all``
loops the per-node function over the Filtering survivors.

Engines that live in modules outside the core import graph (the CUDA
kernels' ``imp_pallas``) register *lazily*: ``get_engine`` imports the
owning module on first use and the module's decorators complete the
registration.
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

    def source_all(self, cluster, workload,
                   nodes: list[int]) -> list[Candidate]:
        """Candidates for all filtered nodes."""
        ...

    def select(self, candidates: list[Candidate], alpha: float) -> Candidate | None:
        """Pick the winning candidate (Eq. 2 unless the engine overrides)."""
        ...


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Function-backed `SourcingEngine` built by ``register_engine``."""

    name: str
    source_node: Callable                   # fn(cluster, workload, node)
    topology_aware: bool = True
    selector: Callable | None = None        # fn(candidates, alpha) -> Candidate

    def source(self, cluster, workload, node: int) -> list[Candidate]:
        return list(self.source_node(cluster, workload, node))

    def source_all(self, cluster, workload,
                   nodes: list[int]) -> list[Candidate]:
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
# import graph: the kernel module owns the CUDA build and its wrappers).
_LAZY: dict[str, str] = {
    "imp_pallas": "repro_torch.kernels.topo_score",
}


def register_engine(
    name: str,
    *,
    topology_aware: bool = True,
    selector: Callable | None = None,
):
    """Decorator: register a per-node sourcing function.

    The function takes ``(cluster, workload, node)`` and returns the
    node's `Candidate` list; ``selector`` replaces the Eq. 2 argmax.
    """

    def deco(fn):
        _REGISTRY[name] = EngineSpec(name=name, source_node=fn,
                                     topology_aware=topology_aware,
                                     selector=selector)
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
