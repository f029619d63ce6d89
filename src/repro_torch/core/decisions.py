"""Unified scheduling decisions and two-phase transactions.

One `SchedulingDecision` describes the outcome of any scheduling attempt —
normal-cycle placement, preemption, or rejection — so no caller has to
isinstance-dispatch over separate result types.  Decisions are produced by
``TopoScheduler.plan`` wrapped in a `Transaction`:

* ``plan()`` evaluates the request against a copy-on-write `ClusterView`;
  the real cluster is untouched.  Reading the planned decision and dropping
  (or ``rollback()``-ing) the transaction is therefore free — the Table 4
  "independent preemptions" protocol is a pure read.
* ``commit()`` validates the plan against the live cluster and applies it:
  victims are evicted, the preemptor is bound, and the decision is completed
  with the live `Instance` objects.
* ``rollback()`` on a *committed* transaction restores the exact prior state:
  the bound instance is evicted and every victim is re-inserted via
  ``Cluster.restore`` with its original uid, node, and GPU/CoreGroup masks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal

from .cluster import Cluster
from .placement import Placement
from .workload import Instance, WorkloadSpec

DecisionKind = Literal["placed", "preempted", "rejected"]

PLANNED = "planned"
COMMITTED = "committed"
ROLLED_BACK = "rolled_back"


@dataclasses.dataclass
class SchedulingDecision:
    """Outcome of one scheduling attempt, uniform across all code paths.

    ``kind``:
      * ``"placed"``    — normal cycle succeeded, no victims.
      * ``"preempted"`` — victims evicted to make room.
      * ``"rejected"``  — no feasible placement even with preemption.

    ``victims`` holds victim instance uids as planned; ``instance`` and
    ``evicted`` are filled in at commit time with the live objects.
    """

    kind: DecisionKind
    workload: WorkloadSpec
    node: int = -1
    placement: Placement | None = None
    hit: bool = False
    victims: tuple[int, ...] = ()
    sourcing_us: float = 0.0
    num_candidates: int = 0
    #: how ``sourcing_us`` was produced: the resolved engine, and whether
    #: ``engine="auto"`` picked it at which node-count threshold.  Excluded
    #: from equality so decision-parity comparisons across engines stay
    #: meaningful.
    sourcing_provenance: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    instance: Instance | None = None
    evicted: list[Instance] = dataclasses.field(default_factory=list)
    txn: "Transaction | None" = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def placed(self) -> bool:
        return self.kind == "placed"

    @property
    def preempted(self) -> bool:
        return self.kind == "preempted"

    @property
    def rejected(self) -> bool:
        return self.kind == "rejected"

    def __bool__(self) -> bool:
        """Truthy iff the request got a placement (placed or preempted)."""
        return self.kind != "rejected"


class TransactionError(RuntimeError):
    """Commit/rollback called in an invalid state, or the plan went stale."""


@dataclasses.dataclass
class Transaction:
    """Two-phase handle around one planned `SchedulingDecision`."""

    cluster: Cluster
    decision: SchedulingDecision
    state: str = PLANNED
    on_event: Callable[[SchedulingDecision, str], None] | None = dataclasses.field(
        default=None, repr=False)
    # the ClusterView the plan was made against and the virtual uid of its
    # planned bind: lets a batch of transactions sharing one view resolve
    # victims that reference earlier (still-virtual) binds at commit time
    view: object | None = dataclasses.field(default=None, repr=False)
    planned_uid: int | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.decision.txn = self

    # -- phase 2: apply -----------------------------------------------------------
    def commit(self) -> SchedulingDecision:
        """Apply the planned decision to the live cluster and return it.

        Rejected decisions commit as no-ops.  A plan whose victims vanished
        or whose placement no longer fits (the cluster changed since
        ``plan()``) raises `TransactionError` and leaves the cluster
        untouched.
        """
        if self.state != PLANNED:
            raise TransactionError(f"cannot commit a {self.state} transaction")
        dec = self.decision
        if dec.rejected:
            self.state = COMMITTED
            return dec
        if self.view is not None:
            # victims planned against an earlier (virtual) bind in the same
            # batch resolve to the real uid that bind committed as
            dec.victims = tuple(self.view.resolve_uid(u) for u in dec.victims)
        missing = [uid for uid in dec.victims if uid not in self.cluster.instances]
        if missing:
            raise TransactionError(
                f"stale plan: victim uids {missing} no longer in the cluster")
        evicted = [self.cluster.evict(uid) for uid in dec.victims]
        free_gpu, free_cg = self.cluster.free_masks(dec.node)
        if (dec.placement.gpu_mask & ~free_gpu) or (dec.placement.cg_mask & ~free_cg):
            for v in evicted:  # put the world back before failing
                self.cluster.restore(v)
            raise TransactionError(
                f"stale plan: placement on node {dec.node} no longer fits")
        dec.evicted = evicted
        dec.instance = self.cluster.bind(dec.workload, dec.node, dec.placement)
        if self.view is not None and self.planned_uid is not None:
            self.view.committed_uids[self.planned_uid] = dec.instance.uid
        self.state = COMMITTED
        if self.on_event is not None:
            self.on_event(dec, COMMITTED)
        return dec

    # -- abandon / reverse --------------------------------------------------------
    def rollback(self) -> None:
        """Discard a planned transaction, or reverse a committed one exactly.

        After rolling back a commit, free masks, instance uids, and every
        victim's full placement are bitwise-identical to the pre-commit
        state (victims are restored with their original uid and masks, not
        rebound as new instances).
        """
        if self.state == ROLLED_BACK:
            return
        if self.state == PLANNED:
            self.state = ROLLED_BACK
            return
        dec = self.decision
        if not dec.rejected:
            self.cluster.evict(dec.instance.uid)
            dec.instance = None
            for victim in dec.evicted:
                self.cluster.restore(victim)
            dec.evicted = []
        self.state = ROLLED_BACK
        if self.on_event is not None:
            self.on_event(dec, ROLLED_BACK)
