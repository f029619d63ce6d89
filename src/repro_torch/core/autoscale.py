"""Diurnal-traffic auto-scaling policies driving preemptive scheduling
(paper §1, §2.3).

Online chat traffic follows a diurnal pattern; offline jobs pad the valleys.
`AutoscalePolicy` converts a traffic level into a desired replica count, and
the `Autoscaler` applies those targets through the transactional scheduler:

* **scale-up** is batched admission — the whole delta is planned against ONE
  snapshot via ``plan_batch`` and the feasible transactions commit in order
  (offline victims are evicted by the commits; the co-location event loop
  in `repro_torch.core.colocation` requeues them).
* **scale-down** releases the *worst-achieved-tier* replicas first
  (cross-socket before same-socket before NUMA-local, deterministic by uid
  within a tier), so diurnal down-ramps defragment the cluster instead of
  freeing random well-placed instances.  The reclaimed capacity's tier
  distribution is reported per `AutoscaleEvent`.
* **backfill** admission goes through chunked ``plan_batch`` rounds
  (normal cycle only) instead of a one-at-a-time ``schedule()`` loop — the
  loop stops the first round nothing places, so it cannot spin when a
  single ``schedule`` flip-flops between placeable and not.

`Autoscaler.step`/`run_day` remain the episodic hour-loop interface; the
event-driven continuous-time day cycle lives in
`repro_torch.core.colocation`, which consumes the same policies as event
sources and drives this module's scale executor from traffic ticks.

Counterpart of the reference's ``repro.core.autoscale``.
"""
from __future__ import annotations

import dataclasses
import math
import time

from .cluster import Cluster
from .placement import achieved_tier
from .scheduler import TopoScheduler
from .workload import Instance, WorkloadSpec


def diurnal_traffic(hour: float, peak: float = 1.0, trough: float = 0.3) -> float:
    """Smooth day curve in [trough, peak], peaking at 14:00."""
    phase = math.cos((hour - 14.0) / 24.0 * 2.0 * math.pi)
    return trough + (peak - trough) * (phase + 1.0) / 2.0


@dataclasses.dataclass
class AutoscalePolicy:
    workload: WorkloadSpec
    min_replicas: int
    max_replicas: int

    def desired(self, load: float) -> int:
        span = self.max_replicas - self.min_replicas
        return self.min_replicas + math.ceil(span * load)


@dataclasses.dataclass
class AutoscaleEvent:
    hour: float
    workload: str
    action: str            # scale_up | scale_down | noop
    delta: int
    preemptions: int
    hits: int
    failures: int
    placements: int = 0    # normal-cycle (non-preemptive) admissions
    #: scale-down only: achieved tier -> number of replicas released at that
    #: tier (the reclaimed-capacity tier distribution; worst tiers first)
    reclaimed_tiers: dict[int, int] = dataclasses.field(default_factory=dict)


class Autoscaler:
    def __init__(self, cluster: Cluster, scheduler: TopoScheduler,
                 policies: list[AutoscalePolicy],
                 backfill: WorkloadSpec | None = None,
                 backfill_chunk: int = 8) -> None:
        self.cluster = cluster
        self.scheduler = scheduler
        self.policies = policies
        self.backfill = backfill
        self.backfill_chunk = backfill_chunk
        self.events: list[AutoscaleEvent] = []
        # replica index: per-class uid -> Instance plus the achieved tier
        # cached at bind time (a placement is immutable for the instance's
        # lifetime, and ``restore`` re-inserts the original masks), kept
        # current through the cluster's instance-op stream.  Turns
        # ``replicas``/``online_reserve_gpus`` and the worst-tier
        # scale-down sort from O(all instances) scans into O(class) work —
        # at 10k nodes the cluster holds tens of thousands of offline
        # instances that a per-policy scan would walk every tick.
        self._by_class: dict[str, dict[int, Instance]] = {}
        self._tier: dict[int, int] = {}
        #: exact committed GPU count over all live instances (ints, so the
        #: incremental sum equals a fresh scan bit-for-bit)
        self.used_gpus = 0
        for inst in cluster.instances.values():
            self._index(+1, inst)
        cluster.add_inst_listener(self._index)
        #: amortized per-request wall time of every ``plan_batch`` issued
        #: through this autoscaler — one entry per planned request, the
        #: SAME metric for host and fused engines (unlike the scheduler's
        #: ``sourcing_us_log``, which host engines append to only on
        #: preemptive plans)
        self.plan_us: list[float] = []

    def _timed_plan_batch(self, workloads, allow_preempt: bool = True,
                          pad_to: int = 0):
        reqs = list(workloads)
        n = len(reqs)
        if pad_to > n:
            # fixed-width device dispatch: the padded tail is planned but
            # NEVER committed — the batch plans sequentially against a
            # shared view, so the first ``n`` decisions are unchanged
            reqs.extend([reqs[-1]] * (pad_to - n))
        # no extra synchronisation: on the card every fused plan ends in a
        # synchronising readback of its result, so the wall time already
        # holds its kernels
        t0 = time.perf_counter()
        txns = self.scheduler.plan_batch(reqs, allow_preempt=allow_preempt)
        per_req = (time.perf_counter() - t0) * 1e6 / max(1, n)
        self.plan_us.extend([per_req] * n)
        return txns[:n]

    def _index(self, delta: int, inst: Instance) -> None:
        name = inst.workload.name
        if delta > 0:
            self._by_class.setdefault(name, {})[inst.uid] = inst
            self._tier[inst.uid] = achieved_tier(self.cluster.spec,
                                                 inst.gpu_mask)
            self.used_gpus += inst.workload.gpus_per_instance
        else:
            cls = self._by_class.get(name)
            if cls is not None:
                cls.pop(inst.uid, None)
            self._tier.pop(inst.uid, None)
            self.used_gpus -= inst.workload.gpus_per_instance

    def replicas(self, name: str) -> list[Instance]:
        """Live replicas of one workload class, uid-ordered."""
        cls = self._by_class.get(name, {})
        return [cls[uid] for uid in sorted(cls)]

    _replicas = replicas        # compat alias

    def online_reserve_gpus(self, next_load: float) -> int:
        """GPUs the next tick's online scale-up will claim across all
        policies.  The two-level backfill ladder
        (`repro_torch.core.colocation`, elastic mode) holds this many free
        GPUs back from whole-instance offline spin-up during rising load, so
        the ramp's online replicas land in the normal cycle instead of
        preempting offline instances that were created one tick earlier —
        shrinking the Eq. 2 victim set instead of growing it."""
        total = 0
        for pol in self.policies:
            want = pol.desired(next_load)
            have = len(self._by_class.get(pol.workload.name, {}))
            total += max(0, want - have) * pol.workload.gpus_per_instance
        return total

    # ---- the scale executor (shared with the co-location event loop) ---------------
    def scale_to(self, policy: AutoscalePolicy, want: int,
                 hour: float = 0.0) -> AutoscaleEvent:
        """Bring one policy's replica count to ``want`` and record the event."""
        current = self._replicas(policy.workload.name)
        delta = want - len(current)
        preemptions = hits = failures = placements = 0
        reclaimed: dict[int, int] = {}
        if delta > 0:
            # batched admission in FIXED-width chunks of
            # ``backfill_chunk`` (final partial chunks pad,
            # single-request remainders take the scalar plan path), as the
            # reference dispatches them.  Decisions are bit-identical to
            # one whole-delta batch: the batch plans sequentially against
            # a shared view and chunks commit in order (the plan/commit
            # interleave invariant, ``TopoScheduler.plan_batch``)
            chunk = self.backfill_chunk
            done = 0
            while done < delta:
                n = min(chunk, delta - done)
                pad = chunk if 1 < n < chunk else 0
                for txn in self._timed_plan_batch([policy.workload] * n,
                                                  pad_to=pad):
                    dec = txn.commit()
                    if dec.rejected:
                        failures += 1
                    elif dec.preempted:
                        preemptions += 1
                        hits += int(dec.hit)
                    else:
                        placements += 1
                done += n
            action = "scale_up"
        elif delta < 0:
            # release the worst-achieved-tier replicas first (cross-socket,
            # then same-socket, then NUMA-local; uid-deterministic within a
            # tier) so down-ramps reclaim badly-distributed capacity; tiers
            # come from the bind-time cache, so the sort is O(class) instead
            # of recomputing masks across the whole fleet
            tiers = self._tier
            victims = sorted(current,
                             key=lambda i: (-tiers[i.uid], i.uid))
            for inst in victims[:-delta]:
                tier = tiers[inst.uid]
                reclaimed[tier] = reclaimed.get(tier, 0) + 1
                self.cluster.evict(inst.uid)
            action = "scale_down"
        else:
            action = "noop"
        ev = AutoscaleEvent(hour, policy.workload.name, action, delta,
                            preemptions, hits, failures, placements,
                            reclaimed)
        self.events.append(ev)
        return ev

    def backfill_valleys(self) -> tuple[int, int]:
        """Chunked ``plan_batch`` admission of the backfill workload.

        Plans ``backfill_chunk`` instances per round against one snapshot
        (normal cycle only — offline padding never preempts) and commits
        the placed ones; stops the first round in which nothing places, so
        a flip-flopping ``schedule`` can never spin the loop.  Returns
        ``(admitted, rejected_in_final_round)``.
        """
        if self.backfill is None:
            return 0, 0
        admitted = 0
        while True:
            txns = self._timed_plan_batch(
                [self.backfill] * self.backfill_chunk, allow_preempt=False)
            placed = [t for t in txns if t.decision.placed]
            for t in placed:
                t.commit()
            admitted += len(placed)
            if len(placed) < len(txns):
                return admitted, len(txns) - len(placed)

    # ---- the episodic hour-loop interface -------------------------------------------
    def step(self, hour: float) -> list[AutoscaleEvent]:
        load = diurnal_traffic(hour)
        out = [self.scale_to(pol, pol.desired(load), hour)
               for pol in self.policies]
        # co-location: offline work continuously pads whatever is free
        # (valleys between online peaks — paper §1 saturation allocation)
        self.backfill_valleys()
        return out

    def run_day(self, step_hours: float = 1.0) -> list[AutoscaleEvent]:
        t = 0.0
        out = []
        while t < 24.0:
            out.extend(self.step(t))
            t += step_hours
        return out
