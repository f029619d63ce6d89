"""FlexTopo — the paper's unified resource-topology representation (§3.2).

Two coupled views of the same state:

* **Graph view** (`FlexTopo`): a graph with Socket / CoreGroup / CPU-Core /
  NUMA / GPU nodes and `host` / `contain` / `localized` / `nearby` edges,
  each annotated per paper Table 2 (`Status`, `UsedBy`, GPU `Model` /
  `Memory Capacity`).  This is the CRD-shaped object the FlexTopo agent
  maintains and the scheduler reads; it serializes to a Kubernetes-CRD-like
  dict.  The graph is held in plain dicts (`TopoGraph`), which keep the
  node insertion order and the ``graph.nodes[key]`` /
  ``graph.nodes(data=True)`` / ``graph.edges(data=True)`` reads of a
  networkx graph, so the package needs nothing beyond torch and numpy.

* **Array view** (`as_masks()` / `ClusterArrays` in cluster.py): free-GPU
  and free-CoreGroup int32 bitmasks per server.  All hot-path scheduling math
  (placement tiers, IMP subset evaluation, the CUDA kernels) runs on this
  encoding; the graph is the source of truth and the masks are derived.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

from .topology import ServerSpec

FREE = "free"
ALLOCATED = "allocated"
FAILED = "failed"


def _gpu(i: int) -> tuple[str, int]:
    return ("gpu", i)


def _cg(i: int) -> tuple[str, int]:
    return ("coregroup", i)


def _core(i: int) -> tuple[str, int]:
    return ("core", i)


def _numa(i: int) -> tuple[str, int]:
    return ("numa", i)


def _socket(i: int) -> tuple[str, int]:
    return ("socket", i)


class _NodeView(dict):
    """key -> attribute dict; calling it iterates like ``nodes(data=...)``."""

    def __call__(self, data: bool = False) -> Iterator:
        return iter(self.items()) if data else iter(self.keys())


class TopoGraph:
    """Undirected attributed graph in plain dicts (insertion-ordered)."""

    def __init__(self) -> None:
        self.nodes = _NodeView()
        self._edges: dict[tuple, dict] = {}

    def add_node(self, key: tuple, **attrs) -> None:
        self.nodes.setdefault(key, {}).update(attrs)

    def add_edge(self, a: tuple, b: tuple, **attrs) -> None:
        self.nodes.setdefault(a, {})
        self.nodes.setdefault(b, {})
        self._edges[(a, b)] = dict(attrs)

    def edges(self, data: bool = False) -> Iterator:
        if data:
            return ((a, b, d) for (a, b), d in self._edges.items())
        return iter(self._edges.keys())


@dataclasses.dataclass
class FlexTopoMasks:
    """Dense bitmask snapshot of one server's allocatable state."""

    free_gpu_mask: int
    free_cg_mask: int


class FlexTopo:
    """Real-time resource topology of a single server (graph view)."""

    def __init__(self, spec: ServerSpec, node_name: str = "node-0") -> None:
        self.spec = spec
        self.node_name = node_name
        self.graph = TopoGraph()
        g = self.graph
        for s in range(spec.num_sockets):
            g.add_node(_socket(s), socket_id=s)
        for u in range(spec.num_numa):
            g.add_node(_numa(u), numa_id=u)
        for c in range(spec.num_coregroups):
            g.add_node(_cg(c), coregroup_id=c, status=FREE, used_by=None)
            # Socket — CoreGroup : host
            g.add_edge(
                _socket(spec.socket_of_numa(spec.numa_of_coregroup(c))),
                _cg(c),
                kind="host",
            )
            # CoreGroup — NUMA : localized
            g.add_edge(_cg(c), _numa(spec.numa_of_coregroup(c)), kind="localized")
            for core in spec.cores_of_coregroup(c):
                g.add_node(_core(core), core_id=core, status=FREE)
                # CoreGroup — core : contain
                g.add_edge(_cg(c), _core(core), kind="contain")
        for dev in range(spec.num_gpus):
            g.add_node(
                _gpu(dev),
                uuid=f"{node_name}-gpu-{dev}",
                model=spec.gpu_model,
                memory_capacity_mb=spec.gpu_memory_mb,
                status=FREE,
                used_by=None,
            )
            # GPU — NUMA : nearby
            g.add_edge(_gpu(dev), _numa(spec.numa_of_gpu(dev)), kind="nearby")

    # ---- allocation state -------------------------------------------------------
    def allocate(self, instance: str, gpus: Iterable[int], coregroups: Iterable[int]) -> None:
        for dev in gpus:
            node = self.graph.nodes[_gpu(dev)]
            if node["status"] != FREE:
                raise ValueError(f"GPU {dev} on {self.node_name} is {node['status']}")
            node["status"] = ALLOCATED
            node["used_by"] = instance
        for c in coregroups:
            node = self.graph.nodes[_cg(c)]
            if node["status"] != FREE:
                raise ValueError(f"CoreGroup {c} on {self.node_name} is {node['status']}")
            node["status"] = ALLOCATED
            node["used_by"] = instance
            for core in self.spec.cores_of_coregroup(c):
                self.graph.nodes[_core(core)]["status"] = ALLOCATED

    def release(self, instance: str) -> None:
        for key, data in self.graph.nodes(data=True):
            if data.get("used_by") == instance:
                data["status"] = FREE
                data["used_by"] = None
                if key[0] == "coregroup":
                    for core in self.spec.cores_of_coregroup(key[1]):
                        self.graph.nodes[_core(core)]["status"] = FREE

    def fail_gpu(self, gpu: int) -> None:
        """Hardware-topology change (§3.3 scenario 2): GPU device failure."""
        self.graph.nodes[_gpu(gpu)]["status"] = FAILED
        self.graph.nodes[_gpu(gpu)]["used_by"] = None

    def repair_gpu(self, gpu: int) -> None:
        if self.graph.nodes[_gpu(gpu)]["status"] == FAILED:
            self.graph.nodes[_gpu(gpu)]["status"] = FREE

    # ---- queries ------------------------------------------------------------------
    def gpu_status(self, gpu: int) -> str:
        return self.graph.nodes[_gpu(gpu)]["status"]

    def cg_status(self, cg: int) -> str:
        return self.graph.nodes[_cg(cg)]["status"]

    def used_by(self) -> dict[str, list[tuple[str, int]]]:
        """instance name -> list of (component kind, id) it holds."""
        out: dict[str, list[tuple[str, int]]] = {}
        for key, data in self.graph.nodes(data=True):
            owner = data.get("used_by")
            if owner is not None:
                out.setdefault(owner, []).append(key)
        return out

    def as_masks(self) -> FlexTopoMasks:
        gpu_mask = 0
        for dev in range(self.spec.num_gpus):
            if self.gpu_status(dev) == FREE:
                gpu_mask |= 1 << dev
        cg_mask = 0
        for c in range(self.spec.num_coregroups):
            if self.cg_status(c) == FREE:
                cg_mask |= 1 << c
        return FlexTopoMasks(free_gpu_mask=gpu_mask, free_cg_mask=cg_mask)

    def instance_masks(self, instance: str) -> FlexTopoMasks:
        """Bitmasks of the resources held by one instance (victim encoding)."""
        gpu_mask = 0
        cg_mask = 0
        for key, data in self.graph.nodes(data=True):
            if data.get("used_by") == instance:
                if key[0] == "gpu":
                    gpu_mask |= 1 << key[1]
                elif key[0] == "coregroup":
                    cg_mask |= 1 << key[1]
        return FlexTopoMasks(free_gpu_mask=gpu_mask, free_cg_mask=cg_mask)

    # ---- CRD (de)serialization ------------------------------------------------------
    def to_crd(self) -> dict:
        """Kubernetes-CRD-shaped dict (the object the agent PATCHes)."""
        spec = self.spec
        return {
            "apiVersion": "scheduling.repro.io/v1alpha1",
            "kind": "FlexTopo",
            "metadata": {"name": self.node_name},
            "spec": {"serverSpec": spec.name},
            "status": {
                "sockets": [
                    {"socketID": s} for s in range(spec.num_sockets)
                ],
                "numaNodes": [
                    {"numaID": u, "socketID": spec.socket_of_numa(u)}
                    for u in range(spec.num_numa)
                ],
                "coreGroups": [
                    {
                        "coreGroupID": c,
                        "cores": list(spec.cores_of_coregroup(c)),
                        "numaID": spec.numa_of_coregroup(c),
                        "status": self.cg_status(c),
                        "usedBy": self.graph.nodes[_cg(c)]["used_by"],
                    }
                    for c in range(spec.num_coregroups)
                ],
                "gpus": [
                    {
                        "uuid": self.graph.nodes[_gpu(d)]["uuid"],
                        "model": spec.gpu_model,
                        "memoryCapacityMB": spec.gpu_memory_mb,
                        "numaID": spec.numa_of_gpu(d),
                        "status": self.gpu_status(d),
                        "usedBy": self.graph.nodes[_gpu(d)]["used_by"],
                    }
                    for d in range(spec.num_gpus)
                ],
            },
        }

    @classmethod
    def from_crd(cls, crd: dict, spec: ServerSpec) -> "FlexTopo":
        topo = cls(spec, node_name=crd["metadata"]["name"])
        for entry in crd["status"]["coreGroups"]:
            c = entry["coreGroupID"]
            node = topo.graph.nodes[_cg(c)]
            node["status"] = entry["status"]
            node["used_by"] = entry["usedBy"]
            if entry["status"] == ALLOCATED:
                for core in spec.cores_of_coregroup(c):
                    topo.graph.nodes[_core(core)]["status"] = ALLOCATED
        for dev, entry in enumerate(crd["status"]["gpus"]):
            node = topo.graph.nodes[_gpu(dev)]
            node["status"] = entry["status"]
            node["used_by"] = entry["usedBy"]
        return topo
