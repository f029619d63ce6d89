"""Event-driven continuous-time co-location engine (paper §1/§2.3, Fig. 2).

The paper's headline scenario — long-running online chat services with
diurnal traffic, offline batch jobs padding the valleys between peaks, and
preemption waves at the ramps — is a *process over time*, not an episodic
experiment.  This module runs it end to end: a priority event queue of
traffic ticks, offline-job submissions/completions, and victim requeues is
driven entirely through the transactional plan/commit API (optional
construction-time kernel warm-up), and every committed
decision streams through the scheduler's listener chain into a per-hour
`ColocationReport`.

Event kinds (stable ordering at equal timestamps):

* ``tick``     — an `AutoscalePolicy` evaluation: the diurnal traffic level
  becomes desired replica counts and the delta is applied through the
  `Autoscaler` scale executor (batched ``plan_batch`` scale-ups that preempt
  offline victims at the ramps; worst-achieved-tier scale-downs that
  defragment on the way down).  Policies are *event sources*: they produce
  no state of their own between ticks.
* ``complete`` — a running offline job finished; its instance is released
  and the reopened capacity is immediately backfilled from the pending
  queue.
* ``requeue``  — a preempted offline victim re-enters the pending queue
  after a short delay and is replanned via chunked ``plan_batch`` admission
  when capacity allows.  The job keeps its workload identity and its
  remaining work; every instance uid it runs under is recorded and uids are
  never reused (`Cluster` uids are monotonic).
* ``submit``   — a new offline job arrives (seeded Poisson process, drawn
  entirely at construction so the arrival stream is identical across
  engines) and enters the pending queue.
* ``scale``    — an explicit one-shot scale-up request; the Fig. 8/9 views
  (`repro_torch.core.simulator.run_timeline` / ``run_allocation_snapshot``)
  are
  day-cycle runs consisting only of these.
* ``ecomplete`` — an offline job hosted at REQUEST granularity inside an
  online replica's spare continuous-batching slots (the elastic layer,
  `repro_torch.serving.elastic`) finished; its slot grant is released.

**The two-level backfill ladder** (``ColocationConfig.elastic=True``) sits
between the day cycle and the per-instance engines: each valley tick first
packs pending offline work into online replicas' spare request slots
through the `ElasticPool` admission controller (SLO-guarded, tier-aware)
and only spins up whole offline instances for the residual — holding back
the next tick's online GPU reserve so ramp scale-ups land in the normal
cycle instead of preempting instances created one tick earlier.  Peak
ramps reverse the ladder: online load reclaims request slots (ejecting
offline requests back to the pending queue — degrade-before-kill) BEFORE
the scale executor preempts whole instances, shrinking the Eq. 2 victim
set.  ``compare_two_level`` A/Bs instance-only vs two-level backfill on
the same seeded day.

**Scheduled performance** follows the paper's Fig. 2 accounting: each live
instance contributes ``gpus x TIER_PERF[achieved tier]`` per hour
(`repro_torch.serving.scheduled_factor` is the same conversion applied to
the
per-decision stream), and the headline metric is the integral of the ONLINE
classes' factor-weighted GPU-hours over the day — the quantity the paper
reports a 55% improvement on for topology-aware preemption.  Offline jobs
are credited separately as completed GPU-hours (goodput).

``compare_day_cycle`` runs the A/B: the same seeded day (identical arrival
stream, identical policies) under a topology-aware engine and a
topology-unaware baseline, reporting the scheduled-performance uplift.

**The O(delta) host loop.**  Per-event host work is independent of cluster
size: progress accrues through an aggregate piecewise-constant rate
accumulator (`_RateAcc` — maintained on every instance bind/evict/restore
via the cluster's inst-listener stream, materialized in a fixed summation
order so it is BIT-exact vs a full per-event scan), same-instant
requeue/submit waves coalesce into one chunked dispatch, backfill
dispatches are skipped by an exact count-feasibility gate when no pending
chunk job can place, and ramp/demotion/scale-down selection reads
maintained per-node and per-tier indexes instead of re-sorting the fleet
(`Autoscaler._index`, ``_offline_by_node``, free-count buckets).
``ColocationConfig.legacy_loop=True`` runs the pre-O(delta) loop — the
scale bench measures events/sec and bit-exact day-metric parity between
the two (`BENCH_colocation.json` ``scale`` block, sizes 24..10240 on
``engine="auto"``).

Counterpart of the reference's ``repro.core.colocation``.  The one
addition is ``ColocationConfig.device``: the device of the cluster the sim
builds (the GPU unless the caller asks for the CPU); a ``cluster=`` passed
in keeps its own.  With ``engine="imp_batched"`` every plan of the day
runs the fused engine's kernels on that device.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
import statistics
import time
from collections import deque

from .agent import AgentFleet
from .autoscale import AutoscalePolicy, Autoscaler, diurnal_traffic
from .cluster import Cluster
from .engines import EngineName
from .perfmodel import relative_scheduled_factor, scheduled_factor
from .placement import achieved_tier
from .scheduler import TopoScheduler
from .topology import RTX4090_SERVER, ServerSpec
from .workload import WorkloadSpec, table3_workloads

# event-kind priorities: stable processing order at equal timestamps
_TICK, _COMPLETE, _REQUEUE, _SUBMIT, _SCALE, _ECOMPLETE = range(6)


@dataclasses.dataclass(frozen=True)
class ColocationConfig:
    """One day-cycle scenario (frozen so A/B runs share it via ``replace``)."""

    num_nodes: int = 16
    spec: ServerSpec = RTX4090_SERVER
    seed: int = 0
    alpha: float = 0.5
    engine: EngineName = "imp_batched"
    warmup: bool = False
    horizon_hours: float = 24.0
    tick_hours: float = 1.0
    #: preempted victims re-enter the pending queue after this delay
    requeue_delay_hours: float = 0.1
    #: floor on a requeued job's remaining work (progress is checkpointed)
    min_requeue_hours: float = 0.05
    #: pending-queue admission rounds plan this many requests per dispatch
    backfill_chunk: int = 8
    #: offline arrivals per hour; None scales with the cluster (2.5 / node,
    #: deliberate oversupply so the allocation stays saturated through the
    #: night and the morning online ramp has to preempt — the paper's §2.3
    #: co-location regime; the surplus queues as backlog)
    offline_rate_per_hour: float | None = None
    mean_job_hours: float = 2.0
    #: day-0 burst that saturates the initial allocation; None -> 4 / node
    initial_offline_jobs: int | None = None
    #: False drops preempted victims instead of requeueing them (the legacy
    #: episodic semantics, kept for the Fig. 8/9 views)
    requeue: bool = True
    #: True enables the two-level backfill ladder: pending offline work is
    #: packed into online replicas' spare request slots (the elastic layer)
    #: before whole offline instances are spun up for the residual
    elastic: bool = False
    #: `repro_torch.serving.elastic.ElasticConfig`; setting it WITHOUT
    #: ``elastic=True`` runs the instance-only ladder under the same SLO
    #: monitor — the A/B baseline that reports attainment without admitting
    #: request-level work.  None with ``elastic=True`` uses the defaults.
    elastic_cfg: object | None = None
    #: shortlist front-end knobs forwarded to `TopoScheduler` (engines that
    #: don't support shortlisting ignore them); ``shortlist_k=0`` disables
    shortlist_k: int = 128
    shortlist_mode: str = "guaranteed"
    #: True runs the pre-O(delta) host loop: a full instance scan per event
    #: in ``_advance``, one ``_drain`` dispatch per requeue/submit event
    #: (no same-timestamp coalescing), and no count-gated dispatch skip.
    #: Decisions and metrics are bit-exact either way — this is the A/B
    #: baseline the scale bench measures events/sec and parity against.
    legacy_loop: bool = False
    #: device of the cluster the sim builds: "cuda" (the card) unless the
    #: caller asks for "cpu", where every kernel wrapper runs its plain
    #: PyTorch version
    device: str = "cuda"


@dataclasses.dataclass
class OfflineJob:
    """One offline batch job across its whole lifecycle (pending -> running
    -> preempted/requeued -> ... -> completed).  ``uids`` records every
    instance uid the job has run under; a replanned job always binds a NEW
    uid (cluster uids are monotonic), preserving workload identity without
    ever resurrecting an evicted instance."""

    jid: int
    workload: WorkloadSpec
    duration_hours: float
    submitted_at: float
    remaining_hours: float
    requeues: int = 0
    uids: tuple[int, ...] = ()
    uid: int | None = None          # live instance uid while running
    started_at: float = 0.0
    completed_at: float | None = None
    #: Fig. 2 progress rate of the CURRENT placement: a degraded tier runs
    #: the job slower, so it occupies its GPUs for proportionally longer
    rate: float = 1.0
    #: times this job was hosted at request granularity (elastic layer)
    elastic_hosts: int = 0
    #: times the job was ejected from request slots (degrade-before-kill)
    ejections: int = 0
    #: set when a preemption requeues the job; cleared (and counted as a
    #: successful replan) by its next start, instance-granular or elastic
    awaiting_replan: bool = False


@dataclasses.dataclass
class HourRow:
    """One reporting interval of a day-cycle run."""

    hour: float                     # interval start (simulation hours)
    load: float                     # diurnal traffic level at the last tick
    counts: dict[str, int]          # live instances by workload at interval end
    scheduled_perf: float           # ONLINE factor-weighted GPU-hours served
    preemptor_perf: float           # ...restricted to preemption-placed instances
    served: dict[str, float]        # per-class factor-weighted GPU-hours
    offline_goodput: float          # completed offline job GPU-hours
    placements: int                 # committed normal-cycle admissions
    preemptions: int
    hits: int                       # topology-affinity hits among preemptions
    failures: int                   # rejected online scale-up requests
    requeued: int                   # victims entering the requeue lifecycle
    requeue_replanned: int          # requeued jobs successfully replanned
    completed_jobs: int
    pending: int                    # offline queue depth at interval end
    crd_patches: int                # FlexTopo agent PATCHes (AgentFleet.watch)
    reclaimed_tiers: dict[int, int]  # scale-down tier distribution
    decision_factor_mean: float     # mean Fig. 2 factor of committed decisions
    #: P50 per-request plan wall time this interval, measured around every
    #: plan/plan_batch call the sim issues — the same metric for host and
    #: fused engines
    plan_p50_us: float
    #: compiles that landed inside this interval
    #: (`simulator.CompileWatch`, which reads 0 in this package: the
    #: kernels are built before the first plan)
    compiled_n: int = 0
    # ---- request-level elastic co-location (two-level ladder) ----
    elastic_admitted: int = 0       # offline jobs packed into request slots
    elastic_ejected: int = 0        # request-level ejections (degrade path)
    elastic_completed: int = 0      # jobs finished inside request slots
    #: whole offline instances demoted into request slots ahead of a ramp
    #: scale-up (each one is an instance preemption that did NOT happen)
    elastic_demoted: int = 0
    elastic_goodput: float = 0.0    # ...their completed GPU-hours
    #: per-class SLO window counts {ok, total, violations, attainment}
    #: (goodput-vs-SLO-violation rows; empty without an SLO monitor)
    slo: dict = dataclasses.field(default_factory=dict)

    def key_metrics(self) -> dict:
        """Deterministic fields only (wall-clock latency and the
        machine-dependent compile tag excluded)."""
        out = dataclasses.asdict(self)
        out.pop("plan_p50_us")
        out.pop("compiled_n")
        return out


@dataclasses.dataclass
class ColocationReport:
    """Per-hour rows + day totals of one co-location day cycle."""

    engine: str
    seed: int
    num_nodes: int
    horizon_hours: float
    hours: list[HourRow] = dataclasses.field(default_factory=list)
    # fold-forward aggregate cache: day-total properties read from here
    # instead of rescanning every hour row on each access (`compare_*`
    # calls them repeatedly, and a 10k-node day has 24+ rows x ~20
    # properties).  Rows are append-only and never mutated after `_flush`,
    # so folding only the NEW rows — left to right, starting from 0 —
    # reproduces a fresh ``sum()`` over all rows bit-for-bit.
    _agg: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)
    _agg_n: int = dataclasses.field(default=0, repr=False, compare=False)
    _km: dict | None = dataclasses.field(default=None, repr=False,
                                         compare=False)
    _km_n: int = dataclasses.field(default=-1, repr=False, compare=False)

    _SUM_FIELDS = ("scheduled_perf", "preemptor_perf", "offline_goodput",
                   "preemptions", "hits", "placements", "failures",
                   "requeued", "requeue_replanned", "completed_jobs",
                   "elastic_admitted", "elastic_ejected",
                   "elastic_completed", "elastic_demoted",
                   "elastic_goodput")

    def _fold(self) -> dict:
        agg = self._agg
        if not agg:
            agg.update({k: 0 for k in self._SUM_FIELDS},
                       slo_ok=0, slo_total=0, slo_violations=0)
        for row in self.hours[self._agg_n:]:
            for k in self._SUM_FIELDS:
                agg[k] += getattr(row, k)
            for c in row.slo.values():
                agg["slo_ok"] += c["ok"]
                agg["slo_total"] += c["total"]
                agg["slo_violations"] += c["violations"]
        self._agg_n = len(self.hours)
        return agg

    @property
    def scheduled_perf(self) -> float:
        return self._fold()["scheduled_perf"]

    @property
    def preemptor_perf(self) -> float:
        """Scheduled performance of preemption-placed instances only — the
        slice of the integral the paper's +55% claim is about."""
        return self._fold()["preemptor_perf"]

    @property
    def offline_goodput(self) -> float:
        return self._fold()["offline_goodput"]

    @property
    def preemptions(self) -> int:
        return self._fold()["preemptions"]

    @property
    def hits(self) -> int:
        return self._fold()["hits"]

    @property
    def hit_rate(self) -> float:
        return self.hits / self.preemptions if self.preemptions else 0.0

    @property
    def placements(self) -> int:
        return self._fold()["placements"]

    @property
    def failures(self) -> int:
        return self._fold()["failures"]

    @property
    def requeued(self) -> int:
        return self._fold()["requeued"]

    @property
    def requeue_replanned(self) -> int:
        return self._fold()["requeue_replanned"]

    @property
    def requeue_success_rate(self) -> float:
        return self.requeue_replanned / self.requeued if self.requeued else 0.0

    @property
    def completed_jobs(self) -> int:
        return self._fold()["completed_jobs"]

    @property
    def elastic_admitted(self) -> int:
        return self._fold()["elastic_admitted"]

    @property
    def elastic_ejected(self) -> int:
        return self._fold()["elastic_ejected"]

    @property
    def elastic_completed(self) -> int:
        return self._fold()["elastic_completed"]

    @property
    def elastic_demoted(self) -> int:
        return self._fold()["elastic_demoted"]

    @property
    def elastic_goodput(self) -> float:
        return self._fold()["elastic_goodput"]

    @property
    def slo_violations(self) -> int:
        return self._fold()["slo_violations"]

    @property
    def slo_attainment(self) -> float:
        """Fraction of online SLO window samples (all monitored classes)
        that met their TTFT/TPOT targets over the day; 1.0 when the run had
        no SLO monitor."""
        agg = self._fold()
        return agg["slo_ok"] / agg["slo_total"] if agg["slo_total"] else 1.0

    def slo_by_class(self) -> dict[str, dict]:
        """Whole-day goodput-vs-SLO rows per monitored class."""
        out: dict[str, dict] = {}
        for row in self.hours:
            for name, c in row.slo.items():
                agg = out.setdefault(name, {"ok": 0, "total": 0,
                                            "violations": 0})
                for k in ("ok", "total", "violations"):
                    agg[k] += c[k]
        for name, agg in out.items():
            agg["attainment"] = (agg["ok"] / agg["total"]
                                 if agg["total"] else 1.0)
        return out

    @property
    def plan_p50_us(self) -> float:
        vals = [r.plan_p50_us for r in self.hours if r.plan_p50_us > 0]
        return statistics.median(vals) if vals else 0.0

    def key_metrics(self) -> dict:
        """Everything deterministic under (seed, engine) — the parity and
        determinism tests compare these dicts whole.  Cached per row count
        (callers like ``compare_*`` and the regression gate call it
        repeatedly); treat the returned dict as read-only."""
        if self._km is not None and self._km_n == len(self.hours):
            return self._km
        self._km_n = len(self.hours)
        self._km = {
            "engine": self.engine,
            "seed": self.seed,
            "num_nodes": self.num_nodes,
            "scheduled_perf": self.scheduled_perf,
            "offline_goodput": self.offline_goodput,
            "preemptions": self.preemptions,
            "hits": self.hits,
            "placements": self.placements,
            "failures": self.failures,
            "requeued": self.requeued,
            "requeue_replanned": self.requeue_replanned,
            "completed_jobs": self.completed_jobs,
            "elastic_admitted": self.elastic_admitted,
            "elastic_ejected": self.elastic_ejected,
            "elastic_completed": self.elastic_completed,
            "elastic_demoted": self.elastic_demoted,
            "elastic_goodput": self.elastic_goodput,
            "slo_violations": self.slo_violations,
            "slo_attainment": self.slo_attainment,
            "hours": [r.key_metrics() for r in self.hours],
        }
        return self._km


def default_policies(cfg: ColocationConfig) -> list[AutoscalePolicy]:
    """Table 3 online mix scaled to the cluster: A and B ride the diurnal
    curve between ~25% of peak and the Table 3 per-100-node peak counts
    (the wide span is what produces the paper's preemption waves at the
    morning ramp and the defragmenting scale-downs at night)."""
    wl = {w.name: w for w in table3_workloads()}
    scale = cfg.num_nodes / 100.0
    a_max = max(1, round(20 * scale))
    b_max = max(2, round(40 * scale))
    return [
        AutoscalePolicy(wl["A"], max(1, round(a_max * 0.25)), a_max),
        AutoscalePolicy(wl["B"], max(1, round(b_max * 0.25)), b_max),
    ]


class _RateAcc:
    """Aggregate Fig. 2 progress-rate accumulator (piecewise-constant).

    One ``{contribution value -> live instance count}`` counter per
    workload class (value = GPUs x relative scheduled factor, so only a
    handful of distinct values exist per class) plus one counter for the
    preemptor slice.  A class rate materializes as ``sum(value * count)``
    in ascending value order — and because TIER_PERF holds non-dyadic
    rationals, THAT fixed summation order is what makes a counter
    maintained incrementally (the O(delta) loop) and a counter rebuilt by
    a full instance scan (the legacy loop) produce bit-identical floats:
    equal multisets sum identically.  ``_advance`` then accrues
    ``rate * dt`` per class instead of walking every live instance.
    """

    __slots__ = ("counts", "pre", "_rates", "_pre_rate")

    def __init__(self) -> None:
        self.counts: dict[str, dict[float, int]] = {}
        self.pre: dict[float, int] = {}
        self._rates: dict[str, float] | None = None
        self._pre_rate: float | None = None

    def add(self, name: str, value: float, delta: int) -> None:
        cnt = self.counts.setdefault(name, {})
        n = cnt.get(value, 0) + delta
        if n:
            cnt[value] = n
        else:
            del cnt[value]
            if not cnt:
                del self.counts[name]
        self._rates = None

    def add_pre(self, value: float, delta: int) -> None:
        n = self.pre.get(value, 0) + delta
        if n:
            self.pre[value] = n
        else:
            del self.pre[value]
        self._pre_rate = None

    @staticmethod
    def _materialize(counter: dict[float, int]) -> float:
        return sum(v * n for v, n in sorted(counter.items()))

    def rates(self) -> tuple[dict[str, float], float]:
        """(per-class rate, preemptor-slice rate), cached until mutated."""
        if self._rates is None:
            self._rates = {name: self._materialize(cnt)
                           for name, cnt in self.counts.items()}
        if self._pre_rate is None:
            self._pre_rate = self._materialize(self.pre)
        return self._rates, self._pre_rate


class ColocationSim:
    """The event loop.  Construct, then ``run()`` once."""

    def __init__(
        self,
        cfg: ColocationConfig,
        policies: list[AutoscalePolicy] | None = None,
        scale_events: list[tuple[float, WorkloadSpec]] | None = None,
        cluster: Cluster | None = None,
    ) -> None:
        self.cfg = cfg
        self.cluster = cluster if cluster is not None else Cluster(
            cfg.spec, cfg.num_nodes, device=cfg.device)
        self.sched = TopoScheduler(self.cluster, engine=cfg.engine,
                                   alpha=cfg.alpha, warmup=cfg.warmup,
                                   shortlist_k=cfg.shortlist_k,
                                   shortlist_mode=cfg.shortlist_mode)
        self.auto = Autoscaler(self.cluster, self.sched,
                               policies if policies is not None else [],
                               backfill_chunk=cfg.backfill_chunk)
        self.fleet = AgentFleet(self.cluster)
        self.fleet.watch(self.sched)
        # scale-downs and job completions evict WITHOUT a transaction;
        # the cluster-event subscription keeps the CRDs fresh for those
        self.fleet.watch_cluster()
        self.sched.add_listener(self._on_decision)
        # Fig. 2 factors: the single source of truth
        # (repro_torch.core.perfmodel; repro_torch.serving re-exports the
        # same objects)
        self._rel_factor = relative_scheduled_factor
        self._scheduled_factor = scheduled_factor

        # request-level elastic layer: the pool + SLO monitor exist whenever
        # an ElasticConfig is in play; cfg.elastic additionally enables the
        # two-level ladder (admission + instance-spin-up reserve).  The
        # monitored-but-instance-only combination is the A/B baseline.
        ecfg = cfg.elastic_cfg
        if ecfg is None and cfg.elastic:
            from repro_torch.serving.elastic import ElasticConfig
            ecfg = ElasticConfig()
        self._ecfg = ecfg
        if ecfg is not None:
            # lazy import keeps the serving stack out of core's import
            # graph until a scenario actually asks for the elastic layer
            from repro_torch.serving.elastic import ElasticPool, SLOMonitor
            self.slo: SLOMonitor | None = SLOMonitor(ecfg)
            self.pool: ElasticPool | None = ElasticPool(ecfg, self.slo)
        else:
            self.slo = None
            self.pool = None
        self._elastic: dict[int, OfflineJob] = {}   # jid -> elastic-hosted
        self._egen: dict[int, int] = {}             # jid -> grant generation

        self.pending: deque[OfflineJob] = deque()
        self.jobs: list[OfflineJob] = []        # every job ever created
        self._running: dict[int, OfflineJob] = {}   # live uid -> job
        self._preemptor_uids: set[int] = set()  # instances placed by preemption
        self._factor_cache: dict[int, float] = {}   # uid -> Fig. 2 rate
        self.timeline: list[dict[str, int]] = []    # Fig. 9 view rows
        self._heap: list[tuple] = []
        self._seq = 0
        self._now = 0.0
        self._row_start = 0.0
        self._last_load = 0.0
        self._next_load = diurnal_traffic(cfg.tick_hours % 24.0)
        self._scale_step = 0
        self._ran = False
        self.report = ColocationReport(engine=cfg.engine, seed=cfg.seed,
                                       num_nodes=cfg.num_nodes,
                                       horizon_hours=cfg.horizon_hours)
        self._reset_acc()
        self._patch_base = self.fleet.store.patch_count
        self._plan_log_base = 0     # index into the autoscaler's plan_us log
        # per-hour compile tagging: rows record how many compiles landed
        # inside their interval, so the latency gate can exclude
        # compile-polluted hours (simulator.CompileWatch; the lazy
        # import dodges the simulator <-> colocation module cycle)
        from .simulator import CompileWatch
        self._watch = CompileWatch.get()
        self._compile_mark = self._watch.mark()
        self._kind_cache: dict[str, str] = {}   # workload name -> kind
        self.events_processed = 0
        #: job-tracked offline instances per node (mirrors ``_running``) —
        #: `_demote_for_block` reads it instead of re-sorting the whole
        #: running set on every ramp
        self._offline_by_node: dict[int, set[int]] = {}
        # ---- O(delta) loop state (unused when cfg.legacy_loop) ----
        # aggregate progress rates + per-node free-GPU/CoreGroup counts +
        # the (gpus, coregroups) -> feasible-node-count gate, all kept
        # current through the cluster's instance-op stream; dead online
        # uids feed the O(changed) pool reconcile
        self._rates = _RateAcc()
        self._free_gpu = [0] * self.cluster.num_nodes
        self._free_cg = [0] * self.cluster.num_nodes
        self._feas: dict[tuple[int, int], int] = {}
        self._dead_online: set[int] = set()
        if not cfg.legacy_loop:
            for n in range(self.cluster.num_nodes):
                fg, fc = self.cluster.free_masks(n)
                self._free_gpu[n] = fg.bit_count()
                self._free_cg[n] = fc.bit_count()
            for inst in self.cluster.instances.values():
                self._rates.add(inst.workload.name,
                                inst.workload.gpus_per_instance
                                * self._instance_factor(inst), +1)
            self.cluster.add_inst_listener(self._on_inst)

        if policies:
            t = 0.0
            while t < cfg.horizon_hours:
                self._push(t, _TICK, None)
                t += cfg.tick_hours
            self._generate_offline_arrivals()
        for t, wl in (scale_events or []):
            self._push(t, _SCALE, wl)
        if scale_events:
            self.timeline.append(dict(self.cluster.count_by_workload(),
                                      step=0))

    # ---- event plumbing --------------------------------------------------------------
    @staticmethod
    def _sort_key(kind: int, payload):
        """Canonical tie-break WITHIN one (timestamp, kind) group: job
        events order by jid, completions by uid — intrinsic identities, so
        the day is invariant to the ORDER same-timestamp events were
        enqueued in (a requeue wave enqueues in victim order, which is an
        engine artifact).  Ticks and explicit scale events keep insertion
        order via the seq element.  Keys are only ever compared within one
        kind, so the per-kind types never mix."""
        if kind in (_REQUEUE, _SUBMIT):
            return payload.jid
        if kind == _COMPLETE:
            return payload          # instance uid
        if kind == _ECOMPLETE:
            return payload          # (jid, generation)
        return 0

    def _push(self, time: float, kind: int, payload) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (time, kind,
                                    self._sort_key(kind, payload),
                                    self._seq, payload))

    def _generate_offline_arrivals(self) -> None:
        """Draw the WHOLE offline arrival stream (times, classes, durations)
        at construction from the seed, so every engine replays the same
        day."""
        cfg = self.cfg
        wl = {w.name: w for w in table3_workloads()}
        rng = random.Random(cfg.seed + 555)
        jid = 0

        def new_job(t: float) -> OfflineJob:
            nonlocal jid
            jid += 1
            # Table 3 offline mix: C (2-GPU) to D (1-GPU) roughly 0.7/0.3
            w = wl["C"] if rng.random() < 0.7 else wl["D"]
            dur = min(8.0, max(0.5, rng.expovariate(1.0 / cfg.mean_job_hours)))
            return OfflineJob(jid=jid, workload=w, duration_hours=dur,
                              submitted_at=t, remaining_hours=dur)

        initial = (cfg.initial_offline_jobs
                   if cfg.initial_offline_jobs is not None
                   else 4 * cfg.num_nodes)
        for _ in range(initial):
            self._push(0.0, _SUBMIT, new_job(0.0))
        rate = (cfg.offline_rate_per_hour
                if cfg.offline_rate_per_hour is not None
                else 2.5 * cfg.num_nodes)
        t = 0.0
        while rate > 0:
            t += rng.expovariate(rate)
            if t >= cfg.horizon_hours:
                break
            self._push(t, _SUBMIT, new_job(t))

    # ---- accounting ------------------------------------------------------------------
    def _reset_acc(self) -> None:
        self._acc = {
            "placements": 0, "preemptions": 0, "hits": 0, "failures": 0,
            "requeued": 0, "requeue_replanned": 0, "completed_jobs": 0,
            "offline_goodput": 0.0, "preemptor_perf": 0.0,
            "served": {}, "reclaimed": {}, "factors": [],
            "elastic_admitted": 0, "elastic_ejected": 0,
            "elastic_completed": 0, "elastic_demoted": 0,
            "elastic_goodput": 0.0,
        }

    def _instance_factor(self, inst) -> float:
        """Fig. 2 factor RELATIVE to the best tier this instance size can
        physically achieve on the SKU (`serving.relative_scheduled_factor`):
        degradation measures scheduling quality, not instance size.  Cached
        per uid — a placement is immutable for the instance's lifetime and
        uids are never reused, so ``_advance`` costs a dict hit per
        instance instead of a bit-scan per event."""
        factor = self._factor_cache.get(inst.uid)
        if factor is None:
            spec = self.cluster.spec
            factor = self._rel_factor(spec,
                                      achieved_tier(spec, inst.gpu_mask),
                                      inst.workload.gpus_per_instance)
            self._factor_cache[inst.uid] = factor
        return factor

    def _on_inst(self, delta: int, inst) -> None:
        """Cluster instance-op stream (bind/evict/restore, transactional or
        not): keep the aggregate rates, the per-node free counts, and the
        count-feasibility gate current in O(1) per mutation."""
        value = (inst.workload.gpus_per_instance
                 * self._instance_factor(inst))
        self._rates.add(inst.workload.name, value, delta)
        if inst.uid in self._preemptor_uids:
            self._rates.add_pre(value, delta)
        node = inst.node
        old_g, old_c = self._free_gpu[node], self._free_cg[node]
        new_g = old_g - delta * inst.gpu_mask.bit_count()
        new_c = old_c - delta * inst.cg_mask.bit_count()
        self._free_gpu[node], self._free_cg[node] = new_g, new_c
        for (ng, nc), cnt in self._feas.items():
            was = old_g >= ng and old_c >= nc
            now = new_g >= ng and new_c >= nc
            if was != now:
                self._feas[(ng, nc)] = cnt + (1 if now else -1)
        if self.pool is not None and inst.workload.kind == "online":
            if delta < 0:
                self._dead_online.add(inst.uid)
            else:
                self._dead_online.discard(inst.uid)

    def _count_feasible(self, workload: WorkloadSpec) -> bool:
        """Does ANY node have enough free GPU/CoreGroup *bits* for this
        workload?  Exactly the normal scheduling cycle's reject condition:
        `TopoScheduler._place_on` falls back to count-based blind placement
        (kubelet degraded admission) on every engine, host and fused alike,
        so count-infeasible everywhere <=> the plan would reject — which
        lets `_drain` skip whole dispatches against a saturated cluster."""
        need = (workload.gpus_per_instance,
                workload.coregroups_per_instance(
                    self.cluster.spec.coregroup_size))
        cnt = self._feas.get(need)
        if cnt is None:             # first query: seed from current counts
            ng, nc = need
            cnt = sum(1 for n in range(self.cluster.num_nodes)
                      if self._free_gpu[n] >= ng and self._free_cg[n] >= nc)
            self._feas[need] = cnt
        return cnt > 0

    def _advance(self, to_time: float) -> None:
        """Accumulate the factor-weighted GPU-hour integrals up to
        ``to_time`` (cluster state is piecewise-constant between events).

        Both loops accrue ``rate * dt`` per class from a `_RateAcc`; the
        O(delta) loop reads the incrementally-maintained one, the legacy
        loop rebuilds an identical counter by scanning every live instance
        — the multisets are equal, so the floats are too (bit-exact parity
        by construction)."""
        dt = to_time - self._now
        if dt > 0:
            if self.cfg.legacy_loop:
                acc = _RateAcc()
                for inst in self.cluster.instances.values():
                    value = (inst.workload.gpus_per_instance
                             * self._instance_factor(inst))
                    acc.add(inst.workload.name, value, +1)
                    if inst.uid in self._preemptor_uids:
                        acc.add_pre(value, +1)
                rates, pre_rate = acc.rates()
            else:
                rates, pre_rate = self._rates.rates()
            served = self._acc["served"]
            for name, rate in rates.items():
                served[name] = served.get(name, 0.0) + rate * dt
            if pre_rate:
                self._acc["preemptor_perf"] += pre_rate * dt
        self._now = to_time

    def _on_decision(self, dec, event: str) -> None:
        """The decision-listener stream: every committed transaction lands
        here (the `AgentFleet` is subscribed right next to us)."""
        if event != "committed" or dec.rejected:
            return
        acc = self._acc
        acc["factors"].append(self._scheduled_factor(dec))
        if dec.preempted:
            acc["preemptions"] += 1
            acc["hits"] += int(dec.hit)
            if dec.instance is not None:
                inst = dec.instance
                self._preemptor_uids.add(inst.uid)
                if not self.cfg.legacy_loop:
                    # the bind op fired BEFORE this listener (commit order:
                    # evict victims, bind, then decision listeners), so the
                    # class rate already counts this instance — only the
                    # preemptor slice starts here, where the uid is marked
                    self._rates.add_pre(inst.workload.gpus_per_instance
                                        * self._instance_factor(inst), +1)
        else:
            acc["placements"] += 1
        if (self.pool is not None and dec.instance is not None
                and dec.instance.workload.kind == "online"):
            inst = dec.instance
            self.pool.register(inst.uid, inst.workload.name,
                               inst.workload.gpus_per_instance,
                               self._instance_factor(inst))
        for victim in dec.evicted:
            job = self._running.pop(victim.uid, None)
            if job is None:
                continue        # not job-tracked (e.g. pre-saturated state)
            self._drop_offline_index(victim.node, victim.uid)
            ran = (self._now - job.started_at) * job.rate
            job.remaining_hours = max(self.cfg.min_requeue_hours,
                                      job.remaining_hours - ran)
            job.requeues += 1
            job.uid = None
            job.awaiting_replan = True
            acc["requeued"] += 1
            if self.cfg.requeue:
                self._push(self._now + self.cfg.requeue_delay_hours,
                           _REQUEUE, job)

    def _flush(self, end: float) -> None:
        acc = self._acc
        served = acc["served"]
        online = sum(v for k, v in served.items()
                     if self._kind_of(k) == "online")
        log = self.auto.plan_us[self._plan_log_base:]
        row = HourRow(
            hour=self._row_start,
            load=self._last_load,
            counts=dict(self.cluster.count_by_workload()),
            scheduled_perf=online,
            preemptor_perf=acc["preemptor_perf"],
            served=dict(served),
            offline_goodput=acc["offline_goodput"],
            placements=acc["placements"],
            preemptions=acc["preemptions"],
            hits=acc["hits"],
            failures=acc["failures"],
            requeued=acc["requeued"],
            requeue_replanned=acc["requeue_replanned"],
            completed_jobs=acc["completed_jobs"],
            pending=len(self.pending),
            crd_patches=self.fleet.store.patch_count - self._patch_base,
            reclaimed_tiers=dict(acc["reclaimed"]),
            decision_factor_mean=(statistics.fmean(acc["factors"])
                                  if acc["factors"] else 0.0),
            plan_p50_us=(statistics.median(log) if log else 0.0),
            compiled_n=self._watch.delta(self._compile_mark),
            elastic_admitted=acc["elastic_admitted"],
            elastic_ejected=acc["elastic_ejected"],
            elastic_completed=acc["elastic_completed"],
            elastic_demoted=acc["elastic_demoted"],
            elastic_goodput=acc["elastic_goodput"],
            slo=(self.slo.drain_counts() if self.slo is not None else {}),
        )
        self.report.hours.append(row)
        self._row_start = end
        self._patch_base = self.fleet.store.patch_count
        self._plan_log_base = len(self.auto.plan_us)
        self._compile_mark = self._watch.mark()
        self._reset_acc()

    def _kind_of(self, name: str) -> str:
        kind = self._kind_cache.get(name)
        if kind is None:            # memo: a class's kind never changes,
            kind = self._kind_of_uncached(name)     # and the fallback walks
            self._kind_cache[name] = kind           # every job ever created
        return kind

    def _kind_of_uncached(self, name: str) -> str:
        for w in self.auto.policies:
            if w.workload.name == name:
                return w.workload.kind
        for j in self.jobs:
            if j.workload.name == name:
                return j.workload.kind
        wl = {w.name: w for w in table3_workloads()}
        return wl[name].kind if name in wl else "online"

    # ---- handlers --------------------------------------------------------------------
    def _handle_tick(self, t: float) -> None:
        if t > self._row_start:
            self._flush(t)
        self._last_load = diurnal_traffic(t % 24.0)
        self._next_load = diurnal_traffic((t + self.cfg.tick_hours) % 24.0)
        if self.pool is not None:
            # the reversed ladder, step 1 (degrade before kill): online
            # load reclaims request slots — ejected offline requests land
            # back in the pending queue — BEFORE the scale executor below
            # preempts whole instances
            for jid in self.pool.set_load(self._last_load):
                self._eject_elastic(jid)
        if self.cfg.elastic and self.pool is not None:
            # reversed ladder, step 2: when the ramp's scale-up has no
            # node-contiguous free block (completions free SCATTERED 1-2
            # GPU fragments), demote whole offline instances into spare
            # request slots to assemble one — an instance preemption that
            # never happens
            self._harvest_for_ramp()
        for pol in self.auto.policies:
            ev = self.auto.scale_to(pol, pol.desired(self._last_load), t)
            self._acc["failures"] += ev.failures
            for tier, n in ev.reclaimed_tiers.items():
                self._acc["reclaimed"][tier] = (
                    self._acc["reclaimed"].get(tier, 0) + n)
        if self.pool is not None:
            self._reconcile_pool()
        self._drain()
        if self.pool is not None:
            self.pool.sample(self._last_load)

    def _handle_submit(self, job: OfflineJob) -> None:
        self.jobs.append(job)
        self.pending.append(job)
        self._drain()

    def _handle_requeue(self, job: OfflineJob) -> None:
        self.pending.append(job)
        self._drain()

    def _drop_offline_index(self, node: int, uid: int) -> None:
        uids = self._offline_by_node.get(node)
        if uids is not None:
            uids.discard(uid)
            if not uids:
                del self._offline_by_node[node]

    def _handle_complete(self, uid: int) -> None:
        job = self._running.get(uid)
        if job is None or job.uid != uid:
            return               # stale event: the job was preempted earlier
        del self._running[uid]
        inst = self.cluster.evict(uid)
        self._drop_offline_index(inst.node, uid)
        job.uid = None
        job.remaining_hours = 0.0
        job.completed_at = self._now
        self._acc["completed_jobs"] += 1
        self._acc["offline_goodput"] += (
            job.duration_hours * job.workload.gpus_per_instance)
        self._drain()

    def _handle_scale(self, workload: WorkloadSpec) -> None:
        """One explicit Algorithm 1 attempt (the Fig. 8/9 view events)."""
        t0 = time.perf_counter()
        txn = self.sched.plan(workload)
        self.auto.plan_us.append((time.perf_counter() - t0) * 1e6)
        dec = txn.commit()
        if dec.rejected:
            self._acc["failures"] += 1
        self._scale_step += 1
        self.timeline.append(dict(self.cluster.count_by_workload(),
                                  step=self._scale_step))

    def _drain(self) -> None:
        """The backfill ladder.  Two-level mode packs pending offline work
        into online replicas' spare request slots FIRST (`_elastic_pack`)
        and spins up whole offline instances only for the residual, capped
        by `_instance_gpu_budget` (free GPUs minus the next tick's online
        reserve).  Instance admission is chunked ``plan_batch`` (normal
        cycle only), FIFO, one pass per trigger; stops as soon as an entire
        chunk fails to place, so a full cluster costs one dispatch."""
        if self.cfg.elastic and self.pool is not None and self.pending:
            self._elastic_pack()
        if not self.pending:
            return
        budget = (self._instance_gpu_budget()
                  if self.cfg.elastic and self.pool is not None else None)
        queue, self.pending = self.pending, deque()
        while queue:
            chunk = []
            while queue and len(chunk) < self.cfg.backfill_chunk:
                need = queue[0].workload.gpus_per_instance
                if budget is not None and need > budget:
                    break       # FIFO head held by the online reserve
                chunk.append(queue.popleft())
                if budget is not None:
                    budget -= need
            if not chunk:
                self.pending.extend(queue)
                return
            any_placed = False
            if self.cfg.legacy_loop:
                txns = self.auto._timed_plan_batch(
                    [j.workload for j in chunk], allow_preempt=False)
                for job, txn in zip(chunk, txns):
                    if txn.decision.placed:
                        dec = txn.commit()
                        self._start_job(job, dec)
                        any_placed = True
                    else:
                        self.pending.append(job)
                        if budget is not None:
                            budget += job.workload.gpus_per_instance
            else:
                # count-gated per-job dispatch.  Normal-cycle placement
                # succeeds iff some node has enough free GPUs AND
                # coregroups (``_place_on`` always falls back to
                # ``place_blind``; the fused engines carry the same
                # degraded blind branch), so a job that fails the count
                # check would reject without mutating state — skip its
                # plan entirely.  Feasible jobs plan singly and commit
                # immediately; the inst-listener refreshes the free-count
                # index between jobs, which keeps the gate exact AND the
                # decisions bit-identical to the legacy shared-view batch
                # (the plan/commit interleave invariant,
                # ``TopoScheduler.plan_batch``).
                for job in chunk:
                    if not self._count_feasible(job.workload):
                        self.pending.append(job)
                        if budget is not None:
                            budget += job.workload.gpus_per_instance
                        continue
                    txn = self.auto._timed_plan_batch(
                        [job.workload], allow_preempt=False)[0]
                    if txn.decision.placed:
                        self._start_job(job, txn.commit())
                        any_placed = True
                    else:        # count gate is exact; defensive only
                        self.pending.append(job)
                        if budget is not None:
                            budget += job.workload.gpus_per_instance
            if not any_placed:
                self.pending.extend(queue)
                return

    def _start_job(self, job: OfflineJob, dec) -> None:
        uid = dec.instance.uid
        assert uid not in job.uids, "instance uid resurrected"
        job.uid = uid
        job.uids += (uid,)
        job.started_at = self._now
        # the placement tier sets the progress rate: a degraded offline
        # instance runs slower and holds its GPUs proportionally longer
        job.rate = self._instance_factor(dec.instance)
        self._running[uid] = job
        self._offline_by_node.setdefault(dec.instance.node, set()).add(uid)
        if job.awaiting_replan:
            job.awaiting_replan = False
            self._acc["requeue_replanned"] += 1
        self._push(self._now + job.remaining_hours / job.rate, _COMPLETE, uid)

    # ---- the request-level elastic layer (two-level ladder, level 1) -----------------
    def _elastic_pack(self) -> None:
        """Ladder step 1: FIFO-pack pending offline jobs into spare request
        slots through the pool's SLO-guarded admission controller.  Jobs no
        replica can host (no spare slots / KV headroom / SLO room) stay
        pending for the instance-granular residual path."""
        keep: deque[OfflineJob] = deque()
        while self.pending:
            job = self.pending.popleft()
            got = self.pool.admit(job.jid, job.workload.gpus_per_instance)
            if got is None:
                keep.append(job)
            else:
                _, slots, rate = got
                self._start_elastic(job, rate)
        self.pending = keep

    def _start_elastic(self, job: OfflineJob, rate: float) -> None:
        job.uid = None
        job.rate = rate
        job.started_at = self._now
        job.elastic_hosts += 1
        self._elastic[job.jid] = job
        gen = self._egen.get(job.jid, 0)
        self._egen[job.jid] = gen
        if job.awaiting_replan:
            # a preempted instance victim replanned INTO request slots
            job.awaiting_replan = False
            self._acc["requeue_replanned"] += 1
        self._acc["elastic_admitted"] += 1
        self._push(self._now + job.remaining_hours / rate, _ECOMPLETE,
                   (job.jid, gen))

    def _eject_elastic(self, jid: int) -> None:
        """Degrade-before-kill: a request-level grant was reclaimed (load
        rise, SLO trip, or host replica gone).  Checkpoint progress and put
        the job straight back in the pending queue — no requeue delay; the
        whole point of request granularity is that ejection is cheap."""
        job = self._elastic.pop(jid, None)
        if job is None:
            return
        ran = (self._now - job.started_at) * job.rate
        job.remaining_hours = max(self.cfg.min_requeue_hours,
                                  job.remaining_hours - ran)
        job.ejections += 1
        self._egen[jid] = self._egen.get(jid, 0) + 1    # void the ecomplete
        self._acc["elastic_ejected"] += 1
        self.pending.append(job)

    def _handle_ecomplete(self, payload: tuple[int, int]) -> None:
        jid, gen = payload
        job = self._elastic.get(jid)
        if job is None or self._egen.get(jid, 0) != gen:
            return               # stale event: the grant was ejected earlier
        del self._elastic[jid]
        self.pool.release(jid)
        job.remaining_hours = 0.0
        job.completed_at = self._now
        acc = self._acc
        acc["completed_jobs"] += 1
        acc["elastic_completed"] += 1
        good = job.duration_hours * job.workload.gpus_per_instance
        acc["offline_goodput"] += good
        acc["elastic_goodput"] += good
        self._drain()

    def _harvest_for_ramp(self) -> None:
        """Reversed ladder, step 2 (the scale executor is step 3).

        The `_instance_gpu_budget` reserve holds back the right GPU
        *count* for the next tick's scale-up, but offline completions free
        scattered 1-2 GPU fragments — an 8-GPU online replica still needs
        a node-contiguous block, and a count-only reserve cannot provide
        one.  Walk this tick's scale-up demand (policy order, the order the
        scale executor runs in) against the per-node free map; when no node
        can host a needed replica, demote whole offline instances into
        spare request slots (SLO-guarded `ElasticPool.admit`, so the jobs
        keep running at request granularity) until one node frees a block.
        Demotion stops the moment the pool cannot absorb a job — then the
        scale executor preempts exactly as before."""
        legacy = self.cfg.legacy_loop
        if legacy:
            free = [self.cluster.free_masks(n)[0].bit_count()
                    for n in range(self.cluster.num_nodes)]

            def take(gpn: int) -> int | None:
                # best-fit against the simulated free map: the tightest
                # node that already fits this replica absorbs it
                return min((n for n in range(len(free)) if free[n] >= gpn),
                           key=lambda n: (free[n], n), default=None)
        else:
            # listener-maintained free counts + lazy free-count buckets:
            # each bucket is a min-heap of node ids whose free count MAY be
            # that value (stale entries are popped on contact), so best-fit
            # is O(num_gpus + log N) per replica instead of an O(N) scan —
            # the heap head of the smallest feasible bucket is exactly the
            # legacy ``min((free[n], n))`` choice
            free = list(self._free_gpu)
            ngpu = self.cluster.spec.num_gpus
            buckets: list[list[int]] = [[] for _ in range(ngpu + 1)]
            for node, cnt in enumerate(free):
                if cnt > 0:
                    buckets[cnt].append(node)   # ascending ids: valid heaps

            def take(gpn: int) -> int | None:
                for cnt in range(gpn, ngpu + 1):
                    b = buckets[cnt]
                    while b and free[b[0]] != cnt:
                        heapq.heappop(b)        # stale since push
                    if b:
                        return heapq.heappop(b)
                return None

        for pol in self.auto.policies:
            have = len(self.auto.replicas(pol.workload.name))
            need_n = pol.desired(self._last_load) - have
            gpn = pol.workload.gpus_per_instance
            for _ in range(max(0, need_n)):
                fit = take(gpn)
                if fit is None:
                    fit = self._demote_for_block(gpn, free)
                    if fit is None:
                        return  # pool saturated: fall back to preemption
                free[fit] -= gpn
                if not legacy and free[fit] > 0:
                    heapq.heappush(buckets[free[fit]], fit)

    def _demote_for_block(self, need: int, free: list[int]) -> int | None:
        """Assemble one ``need``-GPU block by demoting offline instances on
        a single node into request slots.  Picks the node reaching the
        block with the fewest demotions (tie: lowest node index), demoting
        largest instances first.  Returns the node, or None if no node can
        reach the block or the pool rejects a job mid-assembly."""
        if self.cfg.legacy_loop:
            by_node: dict[int, list] = {}
            for uid in sorted(self._running):
                inst = self.cluster.instances.get(uid)
                if inst is not None:
                    by_node.setdefault(inst.node, []).append(inst)
            items = sorted(by_node.items())
        else:
            # per-node offline-instance index maintained at every
            # start/complete/preempt/demote — same node order and same
            # uid-sorted candidate lists as the legacy full-_running scan
            items = [(n, [self.cluster.instances[u]
                          for u in sorted(self._offline_by_node[n])])
                     for n in sorted(self._offline_by_node)]
        best = None             # (demotions, node, victims)
        for n, insts in items:
            insts = sorted(insts, key=lambda i: (
                -i.workload.gpus_per_instance, i.uid))
            got, take = free[n], []
            for inst in insts:
                if got >= need:
                    break
                take.append(inst)
                got += inst.workload.gpus_per_instance
            if got >= need and (best is None or (len(take), n) < best[:2]):
                best = (len(take), n, take)
        if best is None:
            return None
        _, node, take = best
        for inst in take:
            if not self._demote_instance(inst):
                # partial assembly still shrinks the Eq. 2 victim set
                return None
            free[node] += inst.workload.gpus_per_instance
        return node

    def _demote_instance(self, inst) -> bool:
        """Demote one running offline instance into request slots: admit
        through the SLO guard FIRST (no admission, no demotion), then
        checkpoint progress, release the instance's GPUs, and continue the
        job at the granted request-level rate."""
        job = self._running.get(inst.uid)
        if job is None:
            return False
        got = self.pool.admit(job.jid, job.workload.gpus_per_instance)
        if got is None:
            return False
        del self._running[inst.uid]
        self.cluster.evict(inst.uid)
        self._drop_offline_index(inst.node, inst.uid)
        ran = (self._now - job.started_at) * job.rate
        job.remaining_hours = max(self.cfg.min_requeue_hours,
                                  job.remaining_hours - ran)
        job.uid = None          # voids the instance's pending _COMPLETE
        self._acc["elastic_demoted"] += 1
        _, _, rate = got
        self._start_elastic(job, rate)
        return True

    def _reconcile_pool(self) -> None:
        """Scale-downs and completions evict online replicas WITHOUT a
        transaction; drop their ReplicaSlots and eject hosted requests."""
        if self.cfg.legacy_loop:
            live = {uid for uid, inst in self.cluster.instances.items()
                    if inst.workload.kind == "online"}
            dead = sorted(set(self.pool.replicas) - live)
        else:
            # O(changed): the inst-listener records every evicted online
            # uid; uids are never reused and replicas register only at
            # commit of live instances, so the intersection with the
            # registered set IS the legacy full-scan difference.
            dead = sorted(u for u in self._dead_online
                          if u in self.pool.replicas)
            self._dead_online.clear()
        for uid in dead:
            for jid in self.pool.unregister(uid):
                self._eject_elastic(jid)

    def _instance_gpu_budget(self) -> int:
        """Ladder step 2 cap: free GPUs minus the online reserve the next
        tick's scale-up will claim (`Autoscaler.online_reserve_gpus`), so
        ramps place online replicas in the normal cycle instead of
        preempting offline instances spun up one tick earlier."""
        if self.cfg.legacy_loop:
            used = sum(i.workload.gpus_per_instance
                       for i in self.cluster.instances.values())
        else:
            used = self.auto.used_gpus     # listener-maintained exact count
        free = self.cluster.spec.num_gpus * self.cluster.num_nodes - used
        return max(0, free - self.auto.online_reserve_gpus(self._next_load))

    # ---- the loop --------------------------------------------------------------------
    def run(self) -> ColocationReport:
        if self._ran:
            raise RuntimeError("ColocationSim.run() is one-shot")
        self._ran = True
        horizon = self.cfg.horizon_hours
        handlers = {
            _TICK: lambda t, p: self._handle_tick(t),
            _COMPLETE: lambda t, p: self._handle_complete(p),
            _REQUEUE: lambda t, p: self._handle_requeue(p),
            _SUBMIT: lambda t, p: self._handle_submit(p),
            _SCALE: lambda t, p: self._handle_scale(p),
            _ECOMPLETE: lambda t, p: self._handle_ecomplete(p),
        }
        heap = self._heap
        coalesce = not self.cfg.legacy_loop
        while heap and heap[0][0] <= horizon:
            t, kind, _, _, payload = heapq.heappop(heap)
            self._advance(t)
            self.events_processed += 1
            if (coalesce and kind in (_REQUEUE, _SUBMIT) and heap
                    and heap[0][0] == t and heap[0][1] == kind):
                # coalesce a same-instant wave (a preemption burst's
                # requeues, a submit cluster) into ONE drain: the sort_key
                # heap element fixes the pop order to jid order, identical
                # to the per-event appends, and deferring `_drain` to the
                # end of the wave plans the whole queue through chunked
                # ``plan_batch`` calls instead of one dispatch per event
                batch = [payload]
                while heap and heap[0][0] == t and heap[0][1] == kind:
                    batch.append(heapq.heappop(heap)[4])
                    self.events_processed += 1
                if kind == _SUBMIT:
                    self.jobs.extend(batch)
                self.pending.extend(batch)
                self._drain()
                continue
            handlers[kind](t, payload)
        self._advance(horizon)
        self._flush(horizon)
        # the run is one-shot: detach from the scheduler so a caller that
        # keeps using it does not stream decisions into a finished report
        self.sched.remove_listener(self._on_decision)
        return self.report


def run_day_cycle(cfg: ColocationConfig,
                  policies: list[AutoscalePolicy] | None = None,
                  ) -> ColocationReport:
    """One full simulated day on the Table 3 mix under ``cfg.engine``."""
    sim = ColocationSim(cfg, policies=policies or default_policies(cfg))
    return sim.run()


def compare_day_cycle(
    cfg: ColocationConfig,
    engines: tuple[str, str] = ("imp_batched", "godel"),
) -> dict:
    """The paper's A/B: the SAME seeded day under a topology-aware engine
    vs a topology-unaware baseline.  Returns the per-engine reports and the
    scheduled-performance uplift ``(aware - baseline) / baseline`` — the
    quantity the paper reports as +55%."""
    aware_name, baseline_name = engines
    reports = {
        name: run_day_cycle(dataclasses.replace(cfg, engine=name))
        for name in engines
    }

    def _uplift(metric: str) -> float:
        base = getattr(reports[baseline_name], metric)
        return ((getattr(reports[aware_name], metric) - base) / base
                if base else 0.0)

    return {
        "engines": engines,
        "reports": reports,
        "uplift": _uplift("scheduled_perf"),
        "preemptor_uplift": _uplift("preemptor_perf"),
        "goodput_uplift": _uplift("offline_goodput"),
    }


def compare_two_level(cfg: ColocationConfig) -> dict:
    """The HyGen-style A/B: the SAME seeded day (identical arrival stream,
    identical policies, identical engine) with the backfill ladder at
    instance granularity only vs the two-level request+instance ladder.

    Both runs carry the same `SLOMonitor`, so online SLO attainment is
    measured identically; the instance-only run simply never admits
    request-level work.  The expected direction: the two-level ladder
    strictly increases offline goodput (valley capacity smaller than one
    instance stops being wasted) at online SLO attainment no worse than the
    baseline, with strictly fewer instance preemptions (the reserve guard,
    request-granular ejection, and ramp-time instance demotion into request
    slots shrink the Eq. 2 victim set at the ramps)."""
    ecfg = cfg.elastic_cfg
    if ecfg is None:
        from repro_torch.serving.elastic import ElasticConfig
        ecfg = ElasticConfig()
    base_cfg = dataclasses.replace(cfg, elastic=False, elastic_cfg=ecfg)
    two_cfg = dataclasses.replace(base_cfg, elastic=True)
    reports = {
        "instance_only": run_day_cycle(base_cfg),
        "two_level": run_day_cycle(two_cfg),
    }
    io, tl = reports["instance_only"], reports["two_level"]
    return {
        "reports": reports,
        "goodput_uplift": ((tl.offline_goodput - io.offline_goodput)
                           / io.offline_goodput if io.offline_goodput
                           else 0.0),
        "slo_attainment": {"instance_only": io.slo_attainment,
                           "two_level": tl.slo_attainment},
        "preemptions": {"instance_only": io.preemptions,
                        "two_level": tl.preemptions},
        "preemption_delta": tl.preemptions - io.preemptions,
        "requeued": {"instance_only": io.requeued, "two_level": tl.requeued},
    }
