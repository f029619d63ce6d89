"""FlexTopo agent — per-node daemon maintaining the FlexTopo CRD (paper §3.3).

Faithful semantics with an in-process stand-in for the API server:

* **Event-driven allocation updates** — the agent subscribes to allocation
  events (bind/evict) and PATCHes the CRD store only when allocation state
  actually changes, avoiding control-plane strain ("instead of continuously
  polling ... reports updates only when changes are detected").
* **Periodic hardware scans** — an infrequent scan compares the live hardware
  state against the internally maintained one and repairs the CRD on
  discrepancies (server failure is left to node-health machinery; GPU-device
  failure is the case the agent handles, §3.3 scenario 2).

Counterpart of the reference's ``repro.core.agent``, on this package's
`FlexTopo` (its graph in plain dicts).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .cluster import Cluster
from .flextopo import FAILED, FlexTopo


@dataclasses.dataclass
class CRDStore:
    """In-process stand-in for the API server's FlexTopo CRD collection."""

    objects: dict[str, dict] = dataclasses.field(default_factory=dict)
    patch_count: int = 0
    watchers: list[Callable[[str, dict], None]] = dataclasses.field(
        default_factory=list)

    def patch(self, name: str, crd: dict) -> None:
        self.objects[name] = crd
        self.patch_count += 1
        for w in self.watchers:
            w(name, crd)

    def get(self, name: str) -> dict | None:
        return self.objects.get(name)

    def watch(self, fn: Callable[[str, dict], None]) -> None:
        self.watchers.append(fn)


class FlexTopoAgent:
    """One agent per node (a DaemonSet member in the paper)."""

    def __init__(self, topo: FlexTopo, store: CRDStore) -> None:
        self.topo = topo
        self.store = store
        self._last_serialized: dict | None = None
        self._known_failed: set[int] = set()
        self.sync()  # initial report

    # -- event-driven path ---------------------------------------------------------
    def on_allocation_event(self) -> bool:
        """Called on bind/evict affecting this node.  Returns True if patched."""
        return self.sync()

    def sync(self) -> bool:
        crd = self.topo.to_crd()
        if crd == self._last_serialized:
            return False   # no change: do NOT strain the control plane
        self.store.patch(self.topo.node_name, crd)
        self._last_serialized = crd
        return True

    # -- periodic hardware scan ------------------------------------------------------
    def periodic_hardware_scan(self) -> bool:
        """Compare live hardware against internal state; patch on discrepancy."""
        failed = {
            g for g in range(self.topo.spec.num_gpus)
            if self.topo.gpu_status(g) == FAILED
        }
        changed = failed != self._known_failed
        self._known_failed = failed
        if changed:
            return self.sync()
        # hardware stable: nothing reported
        return False


class AgentFleet:
    """All agents of a cluster + the event wiring from cluster mutations."""

    def __init__(self, cluster: Cluster) -> None:
        self.store = CRDStore()
        self.agents = [FlexTopoAgent(t, self.store) for t in cluster.topos]
        self.cluster = cluster

    def notify(self, node: int) -> bool:
        return self.agents[node].on_allocation_event()

    def watch(self, scheduler) -> None:
        """Subscribe to a TopoScheduler's transaction commits/rollbacks."""
        scheduler.add_listener(self.on_decision)

    def watch_cluster(self) -> None:
        """Subscribe to the cluster's per-node invalidation events so
        NON-transactional mutations (autoscaler scale-downs, offline-job
        completions — plain ``Cluster.evict`` calls that never flow through
        a Transaction) also patch the CRDs, per the paper's §3.3
        event-driven allocation reporting.  Safe to combine with ``watch``:
        ``sync`` is change-deduplicated, so double notification never
        issues a second PATCH."""
        self.cluster.add_dirty_listener(self.notify)

    def on_decision(self, decision, event: str | None = None) -> int:
        """Allocation event from a committed (or rolled-back) transaction:
        sync every node the decision touched.  Returns #patches issued."""
        nodes = set()
        if decision.node >= 0:
            nodes.add(decision.node)
        nodes.update(v.node for v in decision.evicted)
        # on rollback, `evicted` has been cleared — the victims' nodes are
        # recoverable from the live registry via the victim uids
        for uid in decision.victims:
            inst = self.cluster.instances.get(uid)
            if inst is not None:
                nodes.add(inst.node)
        return sum(self.notify(n) for n in sorted(nodes))

    def scan_all(self) -> int:
        return sum(a.periodic_hardware_scan() for a in self.agents)

    def inject_gpu_failure(self, node: int, gpu: int) -> None:
        """Test/ops hook: fail a device, let the scan repair the CRD view."""
        self.cluster.topos[node].fail_gpu(gpu)
        self.cluster.invalidate_node(node)
