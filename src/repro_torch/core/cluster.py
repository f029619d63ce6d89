"""Cluster state: N servers × FlexTopo + the instance registry (host half).

The scheduler and simulator mutate cluster state exclusively through this
class so that the FlexTopo graphs, the bitmask arrays, and the instance
registry can never diverge.  ``arrays()`` exports the dense per-node view.

A cluster names the torch device its kernels run on (``device="cuda"`` by
default).  The host state lives in Python objects either way; the device is
where an engine such as ``imp_pallas`` sends its per-node subset tensors.
A cluster asked for CUDA on a machine without it raises instead of quietly
running on the CPU.

`Cluster.from_instances` rebuilds a cluster from plain instance rows with
the exact uids kept (`instance_rows` exports them), which is how another
implementation's cluster state is carried into this one: victim order is
``(priority, uid)``, so uids decide decisions.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, Iterable

import numpy as np
import torch

from .flextopo import FlexTopo
from .placement import Placement
from .topology import ServerSpec
from .workload import Instance, TopoPolicy, WorkloadSpec

#: Widest per-node victim set the dense subset sweep encodes (2^16 lanes).
#: Nodes holding more victims than this are sourced through the per-node
#: python engine instead (see ``kernels.topo_score.flextopo_imp_pallas``).
MAX_DENSE_VICTIMS = 16

#: One instance as plain values:
#: ``(uid, workload fields as a dict, node, gpu_mask, cg_mask)``.
InstanceRow = tuple[int, dict, int, int, int]


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device a cluster runs its kernels on; CUDA must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


@dataclasses.dataclass
class ClusterArrays:
    """Dense snapshot for the vectorized engines."""

    free_gpu: np.ndarray      # int32[N] free-GPU bitmask per node
    free_cg: np.ndarray       # int32[N] free-CoreGroup bitmask per node
    numa_gpu_masks: np.ndarray    # int32[U]
    numa_cg_masks: np.ndarray     # int32[U]
    socket_of_numa: np.ndarray    # int32[U]


def _plain(value):
    return value.value if isinstance(value, enum.Enum) else value


def instance_rows(cluster) -> list[InstanceRow]:
    """Every instance of ``cluster`` as a plain row, in uid order.

    Reads only ``cluster.instances`` (uid -> instance with ``workload``,
    ``node``, ``gpu_mask``, ``cg_mask``), so it exports any cluster with
    that shape."""
    rows = []
    for uid in sorted(cluster.instances):
        inst = cluster.instances[uid]
        fields = {f.name: _plain(getattr(inst.workload, f.name))
                  for f in dataclasses.fields(inst.workload)}
        rows.append((int(uid), fields, int(inst.node), int(inst.gpu_mask),
                     int(inst.cg_mask)))
    return rows


class Cluster:
    def __init__(self, spec: ServerSpec, num_nodes: int,
                 device: str | torch.device = "cuda") -> None:
        self.spec = spec
        self.num_nodes = num_nodes
        self.device = resolve_device(device)
        self.topos = [FlexTopo(spec, node_name=f"node-{i}") for i in range(num_nodes)]
        self.instances: dict[int, Instance] = {}
        self._uid = itertools.count()
        # per-node instance index + cached free masks: turns victims_on /
        # free_masks from O(total instances) scans into O(node) lookups
        self._by_node: list[set[int]] = [set() for _ in range(num_nodes)]
        self._mask_cache: list[tuple[int, int] | None] = [None] * num_nodes
        # node-dirty fan-out: every mutation funnels through invalidate_node
        self._dirty_listeners: list[Callable[[int], None]] = []
        # op fan-out: bind/evict/restore ALSO publish the exact mutation
        # (node, ±1, gpu_mask, cg_mask, priority, uid, preemptible)
        self._op_listeners: list[Callable[[tuple], None]] = []
        # instance fan-out: the same stream with the WHOLE Instance attached
        self._inst_listeners: list[Callable[[int, "Instance"], None]] = []

    @classmethod
    def from_instances(cls, spec: ServerSpec, num_nodes: int,
                       rows: Iterable[InstanceRow],
                       device: str | torch.device = "cuda") -> "Cluster":
        """Rebuild a cluster from plain instance rows (see `instance_rows`).

        Each instance goes in through ``restore``, so it keeps its uid,
        node and masks exactly; the uid counter then continues past the
        largest uid, as it would have in the cluster the rows came from."""
        cluster = cls(spec, num_nodes, device=device)
        workloads: dict[tuple, WorkloadSpec] = {}
        top = -1
        for uid, fields, node, gpu_mask, cg_mask in rows:
            key = tuple(sorted(fields.items()))
            wl = workloads.get(key)
            if wl is None:
                kw = dict(fields)
                kw["numa_policy"] = TopoPolicy(kw["numa_policy"])
                kw["socket_policy"] = TopoPolicy(kw["socket_policy"])
                wl = workloads[key] = WorkloadSpec(**kw)
            cluster.restore(Instance(uid=int(uid), workload=wl, node=int(node),
                                     gpu_mask=int(gpu_mask),
                                     cg_mask=int(cg_mask)))
            top = max(top, int(uid))
        cluster._uid = itertools.count(top + 1)
        return cluster

    # ---- mutation -----------------------------------------------------------------
    def bind(self, workload: WorkloadSpec, node: int, placement: Placement) -> Instance:
        inst = Instance(uid=next(self._uid), workload=workload, node=node,
                        gpu_mask=placement.gpu_mask, cg_mask=placement.cg_mask)
        gpus = [g for g in range(self.spec.num_gpus) if placement.gpu_mask >> g & 1]
        cgs = [c for c in range(self.spec.num_coregroups) if placement.cg_mask >> c & 1]
        self.topos[node].allocate(inst.name, gpus, cgs)
        self.instances[inst.uid] = inst
        self._by_node[node].add(inst.uid)
        self._emit_op(node, +1, inst)
        self._emit_inst(+1, inst)
        self.invalidate_node(node)
        return inst

    def evict(self, uid: int) -> Instance:
        inst = self.instances.pop(uid)
        self.topos[inst.node].release(inst.name)
        self._by_node[inst.node].discard(uid)
        self._emit_op(inst.node, -1, inst)
        self._emit_inst(-1, inst)
        self.invalidate_node(inst.node)
        return inst

    def restore(self, inst: Instance) -> Instance:
        """Re-insert a previously evicted instance with full fidelity.

        Unlike ``bind``, the instance keeps its original uid, node, and
        GPU/CoreGroup masks — this is what ``Transaction.rollback`` uses so
        that reversing a preemption is bitwise-exact.
        """
        if inst.uid in self.instances:
            raise ValueError(f"uid {inst.uid} already bound")
        gpus = [g for g in range(self.spec.num_gpus) if inst.gpu_mask >> g & 1]
        cgs = [c for c in range(self.spec.num_coregroups) if inst.cg_mask >> c & 1]
        self.topos[inst.node].allocate(inst.name, gpus, cgs)
        self.instances[inst.uid] = inst
        self._by_node[inst.node].add(inst.uid)
        self._emit_op(inst.node, +1, inst)
        self._emit_inst(+1, inst)
        self.invalidate_node(inst.node)
        return inst

    def invalidate_node(self, node: int) -> None:
        """Single choke point for node-state changes: drops the free-mask
        cache and notifies dirty listeners."""
        self._mask_cache[node] = None
        for fn in self._dirty_listeners:
            fn(node)

    def add_dirty_listener(self, fn: Callable[[int], None]) -> None:
        """Subscribe to per-node invalidation events (bind/evict/restore)."""
        self._dirty_listeners.append(fn)

    def _emit_op(self, node: int, delta: int, inst: Instance) -> None:
        if self._op_listeners:
            op = (node, delta, inst.gpu_mask, inst.cg_mask, inst.priority,
                  inst.uid, inst.preemptible)
            for fn in self._op_listeners:
                fn(op)

    def _emit_inst(self, delta: int, inst: Instance) -> None:
        for fn in self._inst_listeners:
            fn(delta, inst)

    def add_inst_listener(self, fn: Callable[[int, Instance], None]) -> None:
        """Subscribe to ``(±1, Instance)`` for every bind/evict/restore.  A
        rollback's ``restore`` emits ``+1`` with the ORIGINAL instance (same
        uid and masks), so a consumer's ±1 bookkeeping is exactly
        reversible."""
        self._inst_listeners.append(fn)

    def add_op_listener(self, fn: Callable[[tuple], None]) -> None:
        """Subscribe to one ``(node, ±1, gpu_mask, cg_mask, priority, uid,
        preemptible)`` tuple per bind/evict/restore.  External
        ``invalidate_node`` calls do NOT produce ops."""
        self._op_listeners.append(fn)

    # ---- queries --------------------------------------------------------------------
    def free_masks(self, node: int) -> tuple[int, int]:
        cached = self._mask_cache[node]
        if cached is None:
            m = self.topos[node].as_masks()
            cached = (m.free_gpu_mask, m.free_cg_mask)
            self._mask_cache[node] = cached
        return cached

    def instances_on(self, node: int) -> list[Instance]:
        return [self.instances[u] for u in self._by_node[node]]

    def victims_on(self, node: int, preemptor_priority: int) -> list[Instance]:
        """Potential victims: strictly lower priority and preemptible."""
        return sorted(
            (
                i for i in self.instances_on(node)
                if i.preemptible and i.priority < preemptor_priority
            ),
            key=lambda i: (i.priority, i.uid),
        )

    def arrays(self) -> ClusterArrays:
        free_gpu = np.zeros(self.num_nodes, dtype=np.int32)
        free_cg = np.zeros(self.num_nodes, dtype=np.int32)
        for n, topo in enumerate(self.topos):
            m = topo.as_masks()
            free_gpu[n] = m.free_gpu_mask
            free_cg[n] = m.free_cg_mask
        return ClusterArrays(
            free_gpu=free_gpu,
            free_cg=free_cg,
            numa_gpu_masks=self.spec.numa_gpu_masks,
            numa_cg_masks=self.spec.numa_cg_masks,
            socket_of_numa=self.spec.socket_of_numa_arr,
        )

    # ---- reporting --------------------------------------------------------------------
    def count_by_workload(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for inst in self.instances.values():
            out[inst.workload.name] = out.get(inst.workload.name, 0) + 1
        return out

    def allocation_snapshot(self) -> list[dict]:
        """Fig. 8-style snapshot: per instance, its node/GPU indices and tier."""
        from .placement import achieved_tier

        rows = []
        for inst in sorted(self.instances.values(), key=lambda i: (i.node, i.uid)):
            gpus = [g for g in range(self.spec.num_gpus) if inst.gpu_mask >> g & 1]
            rows.append({
                "instance": inst.name,
                "workload": inst.workload.name,
                "node": inst.node,
                "gpus": gpus,
                "tier": achieved_tier(self.spec, inst.gpu_mask),
            })
        return rows

    def view(self) -> "ClusterView":
        """Copy-on-write planning view over the current state."""
        return ClusterView(self)

    def cross_socket_instances(self) -> int:
        """Fig. 8 headline number: instances whose GPUs span sockets."""
        from .placement import achieved_tier, min_tier_for

        return sum(
            1
            for inst in self.instances.values()
            if inst.gpu_mask
            and achieved_tier(self.spec, inst.gpu_mask)
            > min_tier_for(self.spec, inst.gpu_mask.bit_count())
        )


class ClusterView:
    """Copy-on-write overlay over a `Cluster` for transactional planning.

    Presents the same read interface the sourcing engines and the scheduler
    use (``spec``, ``num_nodes``, ``device``, ``free_masks``,
    ``instances_on``, ``victims_on``) but records evictions and binds
    locally instead of mutating the base cluster.  Planned binds get
    *virtual* (negative) uids so they can never collide with live
    instances; ``Transaction.commit`` later replays the plan onto the base
    cluster for real.

    One view can host several ``plan()`` calls (``plan_batch``): later plans
    see earlier planned evictions/binds, so a batch of decisions composes
    against a single snapshot.
    """

    def __init__(self, base: Cluster) -> None:
        self.base = base
        self.spec = base.spec
        self.num_nodes = base.num_nodes
        self.device = base.device
        self._evicted: dict[int, Instance] = {}
        self._added: dict[int, Instance] = {}
        self._uid = itertools.count(-1, -1)
        # virtual uid -> real uid, filled as the view's transactions commit so
        # later transactions can resolve victims planned against earlier binds
        self.committed_uids: dict[int, int] = {}

    # -- read interface (mirrors Cluster) ------------------------------------------
    def free_masks(self, node: int) -> tuple[int, int]:
        fg, fc = self.base.free_masks(node)
        for inst in self._evicted.values():
            if inst.node == node:
                fg |= inst.gpu_mask
                fc |= inst.cg_mask
        for inst in self._added.values():
            if inst.node == node:
                fg &= ~inst.gpu_mask
                fc &= ~inst.cg_mask
        return fg, fc

    def instances_on(self, node: int) -> list[Instance]:
        live = [i for i in self.base.instances_on(node)
                if i.uid not in self._evicted]
        live.extend(i for i in self._added.values() if i.node == node)
        return live

    def victims_on(self, node: int, preemptor_priority: int) -> list[Instance]:
        return sorted(
            (
                i for i in self.instances_on(node)
                if i.preemptible and i.priority < preemptor_priority
            ),
            key=lambda i: (i.priority, i.uid),
        )

    # -- planned mutations ----------------------------------------------------------
    def plan_evict(self, uid: int) -> Instance:
        if uid in self._added:
            return self._added.pop(uid)
        inst = self.base.instances[uid]
        if uid in self._evicted:
            raise ValueError(f"uid {uid} already planned for eviction")
        self._evicted[uid] = inst
        return inst

    def plan_bind(self, workload: WorkloadSpec, node: int,
                  placement: Placement) -> Instance:
        inst = Instance(uid=next(self._uid), workload=workload, node=node,
                        gpu_mask=placement.gpu_mask, cg_mask=placement.cg_mask)
        self._added[inst.uid] = inst
        return inst

    def resolve_uid(self, uid: int) -> int:
        """Map a virtual (planned-bind) uid to the real uid it committed as."""
        return self.committed_uids.get(uid, uid)
