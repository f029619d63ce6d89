"""Cluster state: N servers × FlexTopo + the instance registry.

The scheduler and simulator mutate cluster state exclusively through this
class so that the FlexTopo graphs, the bitmask arrays, and the instance
registry can never diverge.  ``arrays()`` exports the dense per-node view,
``sourcing_context()`` hands out the incrementally-maintained host
`SourcingContext` mirror, and ``device_state()`` hands out the
`DeviceClusterState`: the struct-of-arrays copy of the sourcing rows that
stays RESIDENT on the cluster's device across plans.  ``invalidate_node``
marks single rows dirty in both; the device copy re-uploads only those rows
as one ``index_copy_`` per sync, so a ``plan()`` never re-uploads the whole
``[N, M]`` state host→device.

A cluster names the torch device its kernels run on (``device="cuda"`` by
default).  The host state lives in Python objects either way; the device is
where the resident state lives and where the engines launch their kernels.
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
import hashlib
import itertools
from typing import Callable, Iterable

import numpy as np
import torch

from .flextopo import FlexTopo
from .placement import Placement
from .topology import ServerSpec
from .workload import Instance, TopoPolicy, WorkloadSpec

#: Widest per-node victim row the dense sourcing arrays encode (2^16
#: subsets).  Nodes holding more preemptible instances than this overflow
#: the row and are sourced through the per-node python engine instead (see
#: ``kernels.topo_score.flextopo_imp_pallas`` and ``preemption_device``).
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
                 node_index: bool = True,
                 device: str | torch.device = "cuda") -> None:
        self.spec = spec
        self.num_nodes = num_nodes
        self.device = resolve_device(device)
        self.topos = [FlexTopo(spec, node_name=f"node-{i}") for i in range(num_nodes)]
        self.instances: dict[int, Instance] = {}
        self._uid = itertools.count()
        # per-node instance index + cached free masks: turns victims_on /
        # free_masks from O(total instances) scans into O(node) lookups
        # (node_index=False is the naive scan, the baseline it is measured
        # against; both give the same answers)
        self.node_index = node_index
        self._by_node: list[set[int]] = [set() for _ in range(num_nodes)]
        self._mask_cache: list[tuple[int, int] | None] = [None] * num_nodes
        # node-dirty fan-out: every mutation funnels through invalidate_node
        self._dirty_listeners: list[Callable[[int], None]] = []
        # op fan-out: bind/evict/restore ALSO publish the exact mutation
        # (node, ±1, gpu_mask, cg_mask, priority, uid, preemptible)
        self._op_listeners: list[Callable[[tuple], None]] = []
        # instance fan-out: the same stream with the WHOLE Instance attached
        self._inst_listeners: list[Callable[[int, "Instance"], None]] = []
        self._sourcing_ctx: "SourcingContext | None" = None
        self._device_state: "DeviceClusterState | None" = None

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

    def remove_dirty_listener(self, fn: Callable[[int], None]) -> None:
        """Unsubscribe ``fn`` (added by `add_dirty_listener`)."""
        self._dirty_listeners.remove(fn)

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

    def sourcing_context(self) -> "SourcingContext":
        """The lazily-created incremental array cache for fused sourcing."""
        if self._sourcing_ctx is None:
            self._sourcing_ctx = SourcingContext(self)
        return self._sourcing_ctx

    def device_state(self, sharded: bool = False,
                     mesh=None) -> "DeviceClusterState":
        """The lazily-created struct-of-arrays state, resident on
        ``self.device``.

        ``sharded=True`` returns (creating, or replacing an unsharded one)
        a `repro_torch.core.cluster_parallel.ShardedDeviceClusterState`:
        the same three stacked tensors with the node axis padded to a
        multiple of the mesh's device count and split into one block of
        rows a device.  ``mesh`` (a `cluster_parallel.Mesh`, or a sequence
        of devices, which may repeat) picks the devices; by default every
        visible CUDA device for a CUDA cluster, the CPU for a CPU cluster.
        An installed sharded state is kept unless ``mesh`` names another.
        The fused engine's pipelines then run a shard at a time and merge
        (the ``imp_sharded`` engine)."""
        if sharded or mesh is not None:
            from .cluster_parallel import ShardedDeviceClusterState, as_mesh

            cur = self._device_state
            want = None if mesh is None else as_mesh(mesh, self.device)
            if not (isinstance(cur, ShardedDeviceClusterState)
                    and (want is None or want == cur.mesh)):
                if cur is not None:     # the replaced state hears no more
                    self.remove_dirty_listener(cur._mark_dirty)
                self._device_state = ShardedDeviceClusterState(self, want)
            return self._device_state
        if self._device_state is None:
            self._device_state = DeviceClusterState(self)
        return self._device_state

    # ---- queries --------------------------------------------------------------------
    def free_masks(self, node: int) -> tuple[int, int]:
        if self.node_index:
            cached = self._mask_cache[node]
            if cached is None:
                m = self.topos[node].as_masks()
                cached = (m.free_gpu_mask, m.free_cg_mask)
                self._mask_cache[node] = cached
            return cached
        m = self.topos[node].as_masks()
        return m.free_gpu_mask, m.free_cg_mask

    def instances_on(self, node: int) -> list[Instance]:
        if self.node_index:
            return [self.instances[u] for u in self._by_node[node]]
        return [i for i in self.instances.values() if i.node == node]

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
        # per-node planned-mutation counter (0 = untouched)
        self._node_version: dict[int, int] = {}

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
    def _bump(self, node: int) -> None:
        self._node_version[node] = self._node_version.get(node, 0) + 1

    def node_version(self, node: int) -> int:
        """Planned-mutation counter for one node (0 = untouched)."""
        return self._node_version.get(node, 0)

    def plan_evict(self, uid: int) -> Instance:
        if uid in self._added:
            inst = self._added.pop(uid)
            self._bump(inst.node)
            return inst
        inst = self.base.instances[uid]
        if uid in self._evicted:
            raise ValueError(f"uid {uid} already planned for eviction")
        self._evicted[uid] = inst
        self._bump(inst.node)
        return inst

    def plan_bind(self, workload: WorkloadSpec, node: int,
                  placement: Placement) -> Instance:
        inst = Instance(uid=next(self._uid), workload=workload, node=node,
                        gpu_mask=placement.gpu_mask, cg_mask=placement.cg_mask)
        self._added[inst.uid] = inst
        self._bump(node)
        return inst

    def resolve_uid(self, uid: int) -> int:
        """Map a virtual (planned-bind) uid to the real uid it committed as."""
        return self.committed_uids.get(uid, uid)

    def delta_nodes(self) -> set[int]:
        """Nodes whose state differs from the base cluster (planned deltas)."""
        return ({i.node for i in self._evicted.values()}
                | {i.node for i in self._added.values()})


class SourcingContext:
    """Incrementally-maintained dense arrays for the fused sourcing path.

    One row per node holds the padded bitmask/priority/uid arrays of ALL
    preemptible instances on that node (sorted by ``(priority, uid)``, the
    same order ``victims_on`` yields).  The preemptor-priority filter is NOT
    baked in: the fused sweep masks victims by ``priority < preemptor`` on
    the device, so one cache serves every preemptor class.

    Invalidation semantics: the context subscribes to the cluster's
    ``invalidate_node`` choke point (hit by every ``bind``/``evict``/
    ``restore``/explicit invalidation) and marks rows dirty; ``refresh()``
    rebuilds only the dirty rows lazily before the next read.

    ``rank`` is each victim's uid-rank within its node's stored victims:
    the fused sweep packs a subset's ranks into a bitmask whose integer
    order equals the lexicographic order of the subset's sorted uid tuple,
    reproducing ``select_best``'s victim-uid tie-break on the device.

    Rows with more than `MAX_DENSE_VICTIMS` preemptible instances are marked
    ``overflow`` but still store the first `cap` victims (the lowest
    ``(priority, uid)`` prefix) plus ``next_prio``, the priority of the
    first victim NOT stored.  Any preemptor's eligible victims are a prefix
    of that order, so a truncated row stays on the fused path whenever
    ``next_prio >= preemptor``; callers fall back to per-node sourcing only
    when eligible victims really exceed the row.

    ``fp`` is each row's equivalence-class fingerprint (`refingerprint`),
    kept at the same refresh points as the rows: the shortlist sweeps one
    representative row a class.
    """

    #: replay gate: a single row accumulating more preemptible additions
    #: than this between refreshes re-encodes instead (bounds the merge
    #: scratch width)
    MAX_REPLAY_ADDS = 64

    def __init__(self, cluster: Cluster, cap: int = MAX_DENSE_VICTIMS) -> None:
        self.cluster = cluster
        self.cap = cap
        n = cluster.num_nodes
        self.free_gpu = np.zeros(n, np.int32)
        self.free_cg = np.zeros(n, np.int32)
        self.vg = np.zeros((n, cap), np.int32)      # victim GPU bitmasks
        self.vc = np.zeros((n, cap), np.int32)      # victim CoreGroup bitmasks
        self.vp = np.zeros((n, cap), np.int32)      # victim priorities
        self.vu = np.zeros((n, cap), np.int64)      # victim uids
        self.rank = np.zeros((n, cap), np.int32)    # uid-rank within the node
        self.stored = np.zeros((n, cap), bool)      # slot holds an instance
        self.count = np.zeros(n, np.int32)          # preemptible instances
        self.overflow = np.zeros(n, bool)           # count > cap: truncated
        self.next_prio = np.full(n, 2**31 - 1, np.int32)  # 1st unstored prio
        self.fp = np.zeros(n, np.int64)             # equivalence-class hash
        self._dirty: set[int] = set(range(n))
        # journal-driven refresh: the exact mutation stream since the last
        # refresh, plus a per-node dirty-mark counter.  A dirty row whose
        # mark count equals its op count was mutated ONLY through
        # bind/evict/restore and replays vectorized; anything else
        # (external invalidation, truncated base row, large add bursts)
        # falls back to `encode_row`.  Rows never encoded (`_fresh`) always
        # do.
        self._journal: list[tuple] = []
        self._marks: dict[int, int] = {}
        self._fresh: set[int] = set(range(n))
        cluster.add_dirty_listener(self._mark)
        cluster.add_op_listener(self._journal.append)

    def _mark(self, node: int) -> None:
        self._dirty.add(node)
        self._marks[node] = self._marks.get(node, 0) + 1

    def refresh(self) -> None:
        """Bring every dirty row up to date: rows whose dirt the op journal
        explains replay in one vectorized numpy merge (`_replay_journal`),
        the rest re-encode through `refresh_row`."""
        if self._dirty:
            for node in self._replay_journal():
                self.refresh_row(node, self.cluster)
        self._dirty.clear()
        self._journal.clear()
        self._marks.clear()

    def _replay_journal(self) -> set[int]:
        """Vectorized journal replay over the replay-safe dirty rows.
        Returns the rows that still need a full `encode_row` rebuild."""
        ops_by_node: dict[int, list[tuple]] = {}
        for op in self._journal:
            ops_by_node.setdefault(op[0], []).append(op)
        bad: set[int] = set()
        rows: list[int] = []
        descs: list[tuple] = []     # (free_gpu, free_cg, keep, adds)
        max_adds = 1
        for node in self._dirty:
            ops = ops_by_node.get(node, ())
            if (node in self._fresh or self.overflow[node]
                    or self._marks.get(node, 0) != len(ops)):
                bad.add(node)
                continue
            # net out the ops: a bind+evict (or evict+restore) of the same
            # uid inside one window cancels exactly
            present: dict[int, tuple] = {}
            removed: set[int] = set()
            fg, fc = int(self.free_gpu[node]), int(self.free_cg[node])
            for _, delta, gm, cm, prio, uid, preempt in ops:
                if delta > 0:
                    fg &= ~gm
                    fc &= ~cm
                    if preempt:
                        if uid in removed:
                            removed.discard(uid)    # evict -> restore
                        else:
                            present[uid] = (prio, uid, gm, cm)
                else:
                    fg |= gm
                    fc |= cm
                    if preempt:
                        if uid in present:
                            del present[uid]
                        else:
                            removed.add(uid)
            stored_uids = set(int(u) for u in self.vu[node][self.stored[node]])
            adds = sorted(present.values())
            if not removed <= stored_uids or len(adds) > self.MAX_REPLAY_ADDS:
                bad.add(node)       # removal outside the stored prefix
                continue
            keep = self.stored[node] & ~np.isin(
                self.vu[node], np.fromiter(removed, np.int64, len(removed)))
            rows.append(node)
            descs.append((fg, fc, keep, adds))
            max_adds = max(max_adds, len(adds))
        if rows:
            self._replay_rows(rows, descs, max_adds)
        return bad

    def _replay_rows(self, rows: list[int], descs: list[tuple],
                     a: int) -> None:
        """One batched (priority, uid) lexsort merge for all replayed rows:
        surviving base victims + net-new additions, exact int64 uids."""
        cap, r = self.cap, len(rows)
        idx = np.asarray(rows, np.int64)
        s = cap + a
        prio = np.full((r, s), 2**31 - 1, np.int32)
        uid = np.full((r, s), np.iinfo(np.int64).max, np.int64)
        gm = np.zeros((r, s), np.int32)
        cm = np.zeros((r, s), np.int32)
        valid = np.zeros((r, s), bool)
        fg = np.zeros(r, np.int32)
        fc = np.zeros(r, np.int32)
        for i, (node, (nfg, nfc, keep, adds)) in enumerate(zip(rows, descs)):
            fg[i], fc[i] = nfg, nfc
            valid[i, :cap] = keep
            prio[i, :cap][keep] = self.vp[node][keep]
            uid[i, :cap][keep] = self.vu[node][keep]
            gm[i, :cap][keep] = self.vg[node][keep]
            cm[i, :cap][keep] = self.vc[node][keep]
            for j, (p_, u_, g_, c_) in enumerate(adds):
                prio[i, cap + j] = p_
                uid[i, cap + j] = u_
                gm[i, cap + j] = g_
                cm[i, cap + j] = c_
                valid[i, cap + j] = True
        order = np.lexsort((uid, prio), axis=-1)
        take = np.take_along_axis
        sv = take(valid, order, 1)
        sp = take(prio, order, 1)
        su = take(uid, order, 1)
        count = valid.sum(axis=1).astype(np.int32)
        overflow = count > cap
        self.free_gpu[idx] = fg
        self.free_cg[idx] = fc
        self.count[idx] = count
        self.overflow[idx] = overflow
        self.next_prio[idx] = np.where(overflow, sp[:, cap], 2**31 - 1)
        st = sv[:, :cap]
        self.stored[idx] = st
        self.vg[idx] = np.where(st, take(gm, order, 1)[:, :cap], 0)
        self.vc[idx] = np.where(st, take(cm, order, 1)[:, :cap], 0)
        self.vp[idx] = np.where(st, sp[:, :cap], 0)
        self.vu[idx] = np.where(st, su[:, :cap], 0)
        ukey = np.where(st, su[:, :cap], np.iinfo(np.int64).max)
        rank = np.argsort(np.argsort(ukey, axis=1, kind="stable"), axis=1)
        self.rank[idx] = np.where(st, rank, 0)
        self.refingerprint(rows)

    def refingerprint(self, rows) -> None:
        """Recompute the 64-bit equivalence-class fingerprint of ``rows``:
        blake2b (8-byte digest) over the bytes of the fields the fused
        sweep scores, in this order: free masks, count, overflow, next
        priority, the victim GPU/CG/priority columns and the stored flags.
        Uids and uid-ranks are left out: rows that differ only in WHICH
        instances fill the slots are interchangeable up to the winner's uid
        tie-break, which comes after the node-id one and so never decides
        between nodes.  Each row is hashed once, over its fields' bytes
        joined (the digest of the reference's field-by-field updates)."""
        for node in rows:
            raw = b"".join((
                self.free_gpu[node].tobytes(), self.free_cg[node].tobytes(),
                self.count[node].tobytes(), self.overflow[node].tobytes(),
                self.next_prio[node].tobytes(), self.vg[node].tobytes(),
                self.vc[node].tobytes(), self.vp[node].tobytes(),
                self.stored[node].tobytes()))
            self.fp[node] = np.frombuffer(
                hashlib.blake2b(raw, digest_size=8).digest(), np.int64)[0]

    def refresh_row(self, node: int, source) -> None:
        """Fill one row from ``source`` (the base cluster or a ClusterView)."""
        self._fresh.discard(node)
        row = encode_row(source, node, self.cap)
        self.free_gpu[node] = row.free_gpu
        self.free_cg[node] = row.free_cg
        self.count[node] = row.count
        self.overflow[node] = row.overflow
        self.next_prio[node] = row.next_priority
        self.stored[node] = row.stored
        self.vg[node] = row.vg
        self.vc[node] = row.vc
        self.vp[node] = row.vp
        self.vu[node] = row.vu
        self.rank[node] = row.rank
        self.refingerprint((node,))


@dataclasses.dataclass
class VictimRow:
    """One node's encoded dense sourcing row (padded to ``cap`` slots)."""

    free_gpu: int
    free_cg: int
    count: int
    overflow: bool           # count > cap: only the prefix is stored
    next_priority: int       # priority of the first victim NOT stored
    vg: np.ndarray           # int32[cap]
    vc: np.ndarray
    vp: np.ndarray
    vu: np.ndarray           # int64[cap]
    rank: np.ndarray
    stored: np.ndarray       # bool[cap]


def encode_row(source, node: int, cap: int) -> VictimRow:
    """Row encoder over any Cluster-like read interface (the base cluster
    for `SourcingContext` rows, a `ClusterView` for per-plan delta rows).

    When a node holds more than ``cap`` preemptible instances only the
    lowest ``(priority, uid)`` prefix is stored; ``next_priority`` lets
    callers decide per preemptor whether the eligible victims still fit.
    """
    fg, fc = source.free_masks(node)
    victims = sorted((i for i in source.instances_on(node) if i.preemptible),
                     key=lambda i: (i.priority, i.uid))
    row = VictimRow(
        free_gpu=fg, free_cg=fc, count=len(victims),
        overflow=len(victims) > cap,
        next_priority=victims[cap].priority if len(victims) > cap
        else 2**31 - 1,
        vg=np.zeros(cap, np.int32), vc=np.zeros(cap, np.int32),
        vp=np.zeros(cap, np.int32), vu=np.zeros(cap, np.int64),
        rank=np.zeros(cap, np.int32), stored=np.zeros(cap, bool),
    )
    victims = victims[:cap]
    for j, v in enumerate(victims):
        row.vg[j] = v.gpu_mask
        row.vc[j] = v.cg_mask
        row.vp[j] = v.priority
        row.vu[j] = v.uid
        row.stored[j] = True
    if victims:
        uids = np.asarray([v.uid for v in victims])
        row.rank[: len(victims)] = np.argsort(np.argsort(uids))
    return row


# ---------------------------------------------------------------------------------
# Device-resident cluster state (struct-of-arrays on the cluster's device)
# ---------------------------------------------------------------------------------

#: rows of the stacked node-state tensor (``DeviceClusterState.nodestate``)
NODE_FIELDS = 5
NS_FREE_GPU, NS_FREE_CG, NS_NODE_ID, NS_OVERFLOW, NS_NEXT_PRIO = range(NODE_FIELDS)

#: rows of the stacked victim tensor (``DeviceClusterState.victims``)
VICTIM_FIELDS = 5
VF_GPU, VF_CG, VF_PRIO, VF_RANK, VF_STORED = range(VICTIM_FIELDS)

#: rows of the stacked drain tensor: free ∪ every stored victim mask — the
#: fully-drained masks Guaranteed Filtering popcounts on the device
DRAIN_FIELDS = 2

#: out-of-range row index that pads scatter/gather index vectors; dropped by
#: `apply_rows` and read as a zero row (with this node id) by gathers
IDX_SENTINEL = 2**31 - 1

#: largest dirty set ``sync(flush=False)`` may leave pending for the
#: in-dispatch overlay before forcing a real scatter (floor — see
#: `max_pending_rows` for the node-count-scaled cap)
MAX_PENDING_ROWS = 16


def _pad_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def max_pending_rows(num_nodes: int) -> int:
    """Node-count-scaled pending-overlay cap (power of two): ~n/64, clamped
    to [`MAX_PENDING_ROWS`, 1024]."""
    return max(MAX_PENDING_ROWS, min(1024, _pad_pow2(max(1, num_nodes // 64))))


def row_width(cap: int) -> int:
    """Length of one flattened row (see `flatten_rows`)."""
    return NODE_FIELDS + VICTIM_FIELDS * cap + DRAIN_FIELDS


def pack_rows(rows: list[VictimRow], node_ids, cap: int):
    """Stack encoded `VictimRow`s into the device layout.

    Returns ``(nodestate int32[NODE_FIELDS, P], victims
    int32[VICTIM_FIELDS, P, cap], drain int32[DRAIN_FIELDS, P])`` — the same
    column layout `DeviceClusterState` keeps resident.
    """
    p = len(rows)
    ns = np.zeros((NODE_FIELDS, p), np.int32)
    v = np.zeros((VICTIM_FIELDS, p, cap), np.int32)
    dr = np.zeros((DRAIN_FIELDS, p), np.int32)
    for j, (node, row) in enumerate(zip(node_ids, rows)):
        ns[NS_FREE_GPU, j] = row.free_gpu
        ns[NS_FREE_CG, j] = row.free_cg
        ns[NS_NODE_ID, j] = node
        ns[NS_OVERFLOW, j] = int(row.overflow)
        ns[NS_NEXT_PRIO, j] = row.next_priority
        v[VF_GPU, j] = row.vg
        v[VF_CG, j] = row.vc
        v[VF_PRIO, j] = row.vp
        v[VF_RANK, j] = row.rank
        v[VF_STORED, j] = row.stored
        dr[0, j] = row.free_gpu | int(
            np.bitwise_or.reduce(np.where(row.stored, row.vg, 0)))
        dr[1, j] = row.free_cg | int(
            np.bitwise_or.reduce(np.where(row.stored, row.vc, 0)))
    return ns, v, dr


def pack_context_rows(ctx: SourcingContext, idx):
    """Vectorized `pack_rows` over `SourcingContext` rows ``idx``."""
    idx = np.asarray(idx, np.int64)
    ns = np.zeros((NODE_FIELDS, len(idx)), np.int32)
    ns[NS_FREE_GPU] = ctx.free_gpu[idx]
    ns[NS_FREE_CG] = ctx.free_cg[idx]
    ns[NS_NODE_ID] = idx
    ns[NS_OVERFLOW] = ctx.overflow[idx]
    ns[NS_NEXT_PRIO] = ctx.next_prio[idx]
    stored = ctx.stored[idx]
    v = np.stack([
        ctx.vg[idx], ctx.vc[idx], ctx.vp[idx], ctx.rank[idx],
        stored.astype(np.int32),
    ]).astype(np.int32)
    dr = np.zeros((DRAIN_FIELDS, len(idx)), np.int32)
    dr[0] = ctx.free_gpu[idx] | np.bitwise_or.reduce(
        np.where(stored, ctx.vg[idx], 0), axis=1)
    dr[1] = ctx.free_cg[idx] | np.bitwise_or.reduce(
        np.where(stored, ctx.vc[idx], 0), axis=1)
    return ns, v, dr


def flatten_rows(ns, v, dr) -> np.ndarray:
    """Concatenate packed rows into ONE int32 row-major buffer
    ``int32[P, row_width(cap)]``: dirty-row scatters and view-delta patches
    travel host→device as a single upload."""
    p = ns.shape[1]
    return np.concatenate(
        [ns.T, v.transpose(1, 0, 2).reshape(p, -1), dr.T],
        axis=1).astype(np.int32)


def unflatten_rows(buf, cap: int):
    """Inverse of `flatten_rows`; works on numpy arrays and torch tensors."""
    p = buf.shape[0]
    ns = buf[:, :NODE_FIELDS].T
    v = buf[:, NODE_FIELDS:NODE_FIELDS + VICTIM_FIELDS * cap]
    v = v.reshape(p, VICTIM_FIELDS, cap).swapaxes(0, 1)
    dr = buf[:, NODE_FIELDS + VICTIM_FIELDS * cap:].T
    return ns, v, dr


def apply_rows(ns, v, dr, idx, buf):
    """The three stacked tensors with the flattened rows ``buf`` written at
    the row indices ``idx``; indices outside ``[0, N)`` (`IDX_SENTINEL`
    pads) are dropped.  Returns new tensors: the resident ones are never
    written.  The plain form of the fused kernels' in-dispatch overlay."""
    a, b, c = unflatten_rows(buf, v.shape[2])
    idx = torch.as_tensor(idx, device=ns.device).to(torch.int64)
    keep = (idx >= 0) & (idx < ns.shape[1])
    if not bool(keep.all()):
        idx, a, b, c = idx[keep], a[:, keep], b[:, keep], c[:, keep]
    return (ns.index_copy(1, idx, a), v.index_copy(1, idx, b),
            dr.index_copy(1, idx, c))


def _scatter_rows(ns, v, dr, idx, buf) -> None:
    """Write the flattened dirty rows ``buf`` into the resident tensors at
    rows ``idx`` (all in range), in place: one ``index_copy_`` each."""
    a, b, c = unflatten_rows(buf, v.shape[2])
    ns.index_copy_(1, idx, a)
    v.index_copy_(1, idx, b)
    dr.index_copy_(1, idx, c)


def pad_idx(ids, floor: int = 1) -> np.ndarray:
    """Pad a row-index list to a power-of-two bucket with `IDX_SENTINEL`."""
    p = max(floor, _pad_pow2(len(ids)))
    out = np.full(p, IDX_SENTINEL, np.int32)
    out[: len(ids)] = ids
    return out


#: the most net-new victims a row of a `ViewDelta` takes on the device;
#: a row with more is encoded on the host
VIEW_DELTA_MAX_ADDS = 8
#: rows of `ViewDelta.descriptors`' dense block: per dense row its node,
#: the removed-slot bitmask, the freed and newly occupied masks, and the
#: row of the patch buffer it is written to
DD_NODE, DD_REM, DD_FOG, DD_FOC, DD_OG, DD_OC, DD_POS = range(7)
DENSE_FIELDS = 7
#: rows of its adds block: per dense row and add, GPU and CG masks,
#: priority, valid flag
ADD_FIELDS = 4


class ViewDelta:
    """The delta rows of one plan's `ClusterView`, as descriptors for the
    device delta encoder (counterpart of the reference's
    ``repro.core.cluster.ViewDelta``).

    Built once per fused plan from the view's planned evictions and binds
    (O(delta instances) host work, no per-node victim sort): a node whose
    patch row the device can rebuild exactly from its resident row gets a
    few descriptor values (`descriptors`); a node behind a gate — its
    resident row pending-stale or never encoded, its base row truncated,
    more than ``a_max`` adds, or more than ``cap`` victims after the merge —
    is encoded on the host by `encode_row` (``fallback``).  Winner uids
    stay on the host: `row` encodes one node on demand.
    """

    def __init__(self, view, ctx: SourcingContext, pending,
                 a_max: int = VIEW_DELTA_MAX_ADDS) -> None:
        self.view = view
        self.cap = cap = ctx.cap
        self.fallback: dict[int, VictimRow] = {}
        self._rows: dict[int, VictimRow] = {}
        dense: list[int] = []
        descs: list[tuple] = []
        max_adds = 1
        per: dict[int, list] = {}
        for inst in view._evicted.values():
            per.setdefault(inst.node, []).append((False, inst))
        for inst in view._added.values():
            per.setdefault(inst.node, []).append((True, inst))
        big = 2**31 - 1
        for node, insts in per.items():
            bad = (node in pending or bool(ctx.overflow[node])
                   or node in ctx._fresh)
            fog = foc = og = oc = 0
            removed: set[int] = set()
            adds: list[tuple] = []
            for is_add, inst in insts:
                if is_add:
                    og |= inst.gpu_mask
                    oc |= inst.cg_mask
                    if inst.preemptible:
                        adds.append((inst.uid, inst.priority,
                                     inst.gpu_mask, inst.cg_mask))
                else:
                    fog |= inst.gpu_mask
                    foc |= inst.cg_mask
                    if inst.preemptible:
                        removed.add(inst.uid)
            # the kept base slots: stored and not evicted (a few slots: a
            # python pass is cheaper than numpy's per-call cost here)
            rem = kept = 0
            kept_vp = []
            for j, (st, uid, vp) in enumerate(zip(
                    ctx.stored[node].tolist(), ctx.vu[node].tolist(),
                    ctx.vp[node].tolist())):
                if st and uid not in removed:
                    kept += 1
                    kept_vp.append(vp)
                else:
                    rem |= (1 << j) if st else 0
                    kept_vp.append(big)
            count = kept + len(adds)
            if bad or len(adds) > a_max or count > cap:
                self.fallback[node] = self.row(node)
                continue
            adds.sort()     # uid ascending: planned binds' uids are < 0
            dense.append(node)
            descs.append((rem, fog, foc, og, oc, adds, kept_vp, count))
            max_adds = max(max_adds, len(adds))
        self.a = _pad_pow2(max_adds)
        d = len(dense)
        self.dense = np.asarray(dense, np.int32)
        self._desc = np.zeros((DENSE_FIELDS, d), np.int32)
        self._adds = np.zeros((ADD_FIELDS, d, self.a), np.int32)
        # host routing metadata: surviving base priorities (2^31 - 1 where
        # no victim stays) + add priorities, and the rows' victim counts
        self._vp = np.asarray([x[6] for x in descs],
                              np.int32).reshape(d, cap)
        self._count = np.asarray([x[7] for x in descs], np.int32)
        for i, (node, (rem, fog, foc, og, oc, adds, _, _)) in enumerate(
                zip(dense, descs)):
            self._desc[:DD_POS, i] = (node, rem, _i32(fog), _i32(foc),
                                      _i32(og), _i32(oc))
            for j, (_, prio, gm, cm) in enumerate(adds):
                self._adds[:, i, j] = (_i32(gm), _i32(cm), prio, 1)
        self._addp_m = np.where(self._adds[3] != 0, self._adds[2],
                                2**31 - 1)
        self._pos = {int(n): i for i, n in enumerate(dense)}

    # -- container interface (the delta-node set) ---------------------------------
    def __len__(self) -> int:
        return len(self._pos) + len(self.fallback)

    def __contains__(self, node: int) -> bool:
        return node in self._pos or node in self.fallback

    def __iter__(self):
        yield from self._pos
        yield from self.fallback

    # -- host routing metadata ----------------------------------------------------
    def elig_bad(self, thresh: int):
        """Per delta node: eligible stored victims under ``thresh`` and
        whether truncation could hide eligible victims (dense rows never
        truncate by construction)."""
        elig = {node: int(((row.vp < thresh) & row.stored).sum())
                for node, row in self.fallback.items()}
        bad = {node: bool(row.overflow) and row.next_priority < thresh
               for node, row in self.fallback.items()}
        if self._pos:
            cnt = ((self._vp < thresh).sum(axis=1)
                   + (self._addp_m < thresh).sum(axis=1))
            for node, i in self._pos.items():
                elig[node] = int(cnt[i])
                bad[node] = False
        return elig, bad

    def count(self, node: int) -> int:
        i = self._pos.get(node)
        if i is not None:
            return int(self._count[i])
        return self.fallback[node].count

    def row(self, node: int) -> VictimRow:
        """Exact host row for one delta node (winner uid decode, wide
        re-dispatches): encoded on demand and cached."""
        row = self._rows.get(node)
        if row is None:
            row = self._rows[node] = encode_row(self.view, node, self.cap)
        return row

    # -- device path ---------------------------------------------------------------
    def descriptors(self, pos) -> tuple[np.ndarray, np.ndarray]:
        """The dense rows' descriptors for the delta encoder: int32
        ``[DENSE_FIELDS, D]`` (node, removed-slot bitmask, freed and
        occupied masks, and ``pos``, the patch-buffer row each is written
        to) and int32 ``[ADD_FIELDS, D, a]`` (the net-new victims in uid
        order)."""
        desc = self._desc.copy()
        desc[DD_POS] = pos
        return desc, self._adds

    def device_rows(self, dcs: "DeviceClusterState"):
        """Every dense delta row encoded on the device: ``(didx
        int32[Dp], buf int32[Dp, row_width])`` with ``Dp`` the power of two
        `pad_idx` gives (rows past ``D`` zero), ``buf`` on the state's
        device; None when every delta node fell back."""
        d = len(self.dense)
        if d == 0:
            return None
        didx = pad_idx(self.dense)
        desc, adds = self.descriptors(np.arange(d, dtype=np.int32))
        up = dcs._upload(np.concatenate([desc.ravel(), adds.ravel()]))
        buf = dcs.delta_encode(up[:desc.size].view(desc.shape),
                               up[desc.size:].view(adds.shape), p=len(didx))
        return didx, buf


def _i32(mask: int) -> int:
    """A 32-bit mask as the int32 the device tensors hold."""
    return mask - (1 << 32) if mask >= 1 << 31 else mask


class DeviceClusterState:
    """Struct-of-arrays view of the cluster's sourcing state, resident on
    ``cluster.device`` (counterpart of the reference's
    ``repro.core.cluster.DeviceClusterState``).

    Three stacked int32 tensors live on the device across plans:

    * ``nodestate [NODE_FIELDS, N]`` — free-GPU/CG slot masks, node id,
      overflow flag, first-unstored priority;
    * ``victims   [VICTIM_FIELDS, N, cap]`` — per-slot victim GPU/CG masks,
      priorities, uid-ranks, stored flags (the ``(priority, uid)``-sorted
      rows of the host `SourcingContext` mirror);
    * ``drain     [DRAIN_FIELDS, N]`` — per-node fully-drained masks (free ∪
      all stored victim masks), the popcount input of the fused Guaranteed
      Filtering.

    The host `SourcingContext` stays as the *mirror*: it keeps the int64
    victim uids (decoded only for the winner) and the counts the host needs
    for wide/overflow routing.  Both subscribe to ``invalidate_node``, so a
    ``bind``/``evict``/``restore`` marks single rows dirty; ``sync()``
    refreshes the mirror and writes ONLY the dirty rows into the resident
    tensors (one upload, one ``index_copy_`` per tensor).  `ClusterView`
    deltas never touch these tensors: the fused kernels read patch rows
    beside them.
    """

    #: the devices the stacked tensors are split over (None: one device;
    #: `cluster_parallel.ShardedDeviceClusterState` sets it)
    mesh = None
    #: the global row of this state's first row (a shard's place in a
    #: sharded state; the unsharded state is its own one shard)
    base = 0

    def __init__(self, cluster: Cluster) -> None:
        self.cluster = cluster
        self.device = cluster.device
        self.mirror = cluster.sourcing_context()
        self.cap = self.mirror.cap
        self.max_pending = max_pending_rows(cluster.num_nodes)
        self.nodestate: torch.Tensor | None = None  # int32[NODE_FIELDS, N]
        self.victims: torch.Tensor | None = None    # int32[VICTIM_FIELDS, N, cap]
        self.drain: torch.Tensor | None = None      # int32[DRAIN_FIELDS, N]
        #: host fast path: when no node stores more than `MIN_M` victims,
        #: per-plan wide/overflow routing is skipped entirely
        self.count_max = 0
        #: monotonic state counter, bumped by every invalidation: entries
        #: of ``plan_cache`` (per-preemptor routing splits + uploaded index
        #: tensors) record the version they were built at and are ignored
        #: once it moves
        self.version = 0
        self.plan_cache: dict = {}
        #: per-version equivalence-class cache: (version, rep bool[N] host
        #: mask, int32[N] device copy), rebuilt lazily by `rep_classes`
        self._rep_cache: tuple | None = None
        self._resident = False      # the first sync uploads everything
        self._dirty: set[int] = set(range(cluster.num_nodes))
        cluster.add_dirty_listener(self._mark_dirty)

    def _mark_dirty(self, node: int) -> None:
        self._dirty.add(node)
        self.version += 1

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def sync(self, flush: bool = True) -> "DeviceClusterState":
        """Bring the device tensors up to date with the live cluster.

        Dirty rows are packed host-side (O(dirty)) and written in place with
        one upload; a majority-dirty state is re-uploaded whole.

        ``flush=False`` refreshes the host mirror but leaves a SMALL dirty
        set resident-stale in ``pending``: the fused kernels read those
        rows from the plan's patch buffer, exactly like view-delta rows,
        saving the separate scatter on the plan hot path.  Pending sets
        above ``max_pending`` are flushed regardless.
        """
        self.mirror.refresh()
        n = self.cluster.num_nodes
        if not self._resident or 2 * len(self._dirty) >= max(n, 2):
            self._upload_full(*pack_context_rows(self.mirror, np.arange(n)))
            self._resident = True
            self._dirty.clear()
        elif self._dirty and (flush or len(self._dirty) > self.max_pending):
            rows = sorted(self._dirty)
            self._scatter(rows, flatten_rows(*pack_context_rows(self.mirror,
                                                                rows)))
            self._dirty.clear()
        self.count_max = int(self.mirror.count.max()) if n else 0
        return self

    def _upload_full(self, ns, v, dr) -> None:
        """The whole state to the device (a rebuild)."""
        self.nodestate = self._upload(ns)
        self.victims = self._upload(v)
        self.drain = self._upload(dr)

    def _scatter(self, rows: list[int], buf: np.ndarray) -> None:
        """The flattened rows ``buf`` written at ``rows``, in place: one
        upload and one ``index_copy_`` a tensor."""
        both = self._upload(np.concatenate(
            [np.asarray(rows, np.int32)[:, None], buf], axis=1))
        _scatter_rows(self.nodestate, self.victims, self.drain,
                      both[:, 0].to(torch.int64), both[:, 1:])

    def _upload_rep(self, rep: np.ndarray):
        """The representative mask on the device, int32."""
        return self._upload(rep.astype(np.int32))

    @property
    def shards(self) -> tuple:
        """The blocks of rows the pipelines run a kernel launch on, each
        with ``device``, ``base``, ``rows`` and its three tensors: this
        state alone (a `cluster_parallel.ShardedDeviceClusterState` has
        one a device of its mesh)."""
        return (self,)

    @property
    def rows(self) -> int:
        """Rows of this block (`shards`): all of them."""
        return self.n_rows

    @property
    def n_rows(self) -> int:
        """Length of the device node axis (``num_nodes``)."""
        return self.cluster.num_nodes

    def rep_classes(self):
        """Equivalence-class representatives over the node axis:
        ``(rep_host bool[n_rows], rep_dev)``, true exactly at the
        LOWEST-index row of every fingerprint class
        (`SourcingContext.refingerprint`).  The winner's tie chain prefers
        the lower node id before any uid comparison, so within a class the
        full sweep's winner is always its lowest row: sweeping the
        representatives alone is exact.  ``rep_dev`` is the mask as int32
        on the device (`_upload_rep`).  Call after ``sync()`` (the
        mirror's fingerprints must be fresh); cached per ``version``."""
        cache = self._rep_cache
        if cache is not None and cache[0] == self.version:
            return cache[1], cache[2]
        n = self.cluster.num_nodes
        rep = np.zeros(self.n_rows, bool)
        _, first = np.unique(self.mirror.fp[:n], return_index=True)
        rep[first] = True
        rep_dev = self._upload_rep(rep)
        self._rep_cache = (self.version, rep, rep_dev)
        return rep, rep_dev

    def delta_encode(self, dense, adds, *, p: int, hpos=None, hrows=None):
        """The view-delta encoder over the resident tensors
        (`repro_torch.kernels.view_delta.encode_delta`): the dense rows
        described by ``dense``/``adds`` (`ViewDelta.descriptors`, on this
        state's device) rebuilt from their resident rows, and the
        host-encoded rows ``hrows`` copied, each to its row of a new
        int32[p, row_width] patch buffer (``dense``'s ``pos`` row and
        ``hpos``); the other rows are zero."""
        from repro_torch.kernels.view_delta import encode_delta

        return encode_delta(self.nodestate, self.victims, dense, adds,
                            hpos, hrows, p=p)

    @property
    def pending(self) -> set[int]:
        """Rows whose device copy is stale (the mirror is fresh after
        sync): deferred by ``sync(flush=False)`` for the in-dispatch
        overlay."""
        return self._dirty

    @property
    def slices(self):
        """The SKU's NUMA/socket slice layout on this state's device
        (`repro_torch.core.placement_device.SpecSlices`)."""
        from .placement_device import spec_slices

        return spec_slices(self.cluster.spec, self.device)
