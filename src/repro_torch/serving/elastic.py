"""Request-level elastic co-location (HyGen lineage): the level-1 layer of
the two-level scheduler.

The paper's preemption is *instance*-granular: a traffic valley is filled by
spinning up whole offline instances and a peak reclaims them by killing
instances, so valley capacity smaller than one instance is wasted and every
ramp pays full preemption + requeue cost.  This module fills valleys at
*request* granularity instead: offline requests are interleaved into online
replicas' spare continuous-batching slots under a latency-SLO interference
bound, and are drained/ejected — degrade-before-kill — the moment the bound
is predicted to break.

Three pieces, sitting between the day cycle
(`repro_torch.core.colocation`) and the per-instance `ServeEngine`:

* `ReplicaSlots`   — per-online-replica accounting of continuous-batching
  slots and KV-cache headroom (`configs.shapes.cache_capacity` over the
  replica's slot budget; offline requests carry a larger KV footprint) at
  the replica's ACHIEVED placement tier.
* `SLOMonitor`     — sliding-window per-class TTFT/TPOT targets with
  tier-aware service rates
  (`repro_torch.core.perfmodel.relative_scheduled_factor` feeds the same
  Fig. 2 factor the day-cycle integral uses).  Violation detection trips
  after ``breach_ticks`` consecutive breaches and recovers with
  hysteresis only after a full clean window, so a replica flapping on the
  SLO boundary is drained and *stays* drained.
* `ElasticPool`    — the admission controller: injects offline requests
  into spare slots only while the monitor predicts the interference stays
  inside the bound, and ejects them (youngest first, whole requests) when
  online load reclaims slots, KV headroom shrinks, or the monitor trips.

The level-2 ladder lives in `repro_torch.core.colocation`: each valley
tick first packs pending offline work into request slots through this pool
and only spins up whole offline instances for the residual; peak ramps
reverse the ladder (eject request-level work before preempting instances).

Counterpart of the reference's ``repro.serving.elastic``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

from repro_torch.configs.shapes import cache_capacity


@dataclasses.dataclass(frozen=True)
class _KVShape:
    """The slice of ModelConfig that `cache_capacity` reads."""
    swa_window: int | None = None


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs of the request-level elastic layer (frozen so A/B runs share
    it via ``dataclasses.replace``)."""

    #: continuous-batching slots one GPU of an online replica contributes
    slots_per_gpu: int = 4
    #: per-slot context budget the KV cache is sized for
    seq_len: int = 4096
    #: sliding-window attention bound (None = full cache), fed to
    #: `configs.shapes.cache_capacity`
    swa_window: int | None = None
    #: KV footprint of an offline request relative to an online slot
    #: (offline batch work carries longer contexts), so KV headroom binds
    #: before slot headroom does
    offline_ctx_factor: float = 2.0
    #: an offline request is admitted only if it gets at least this fraction
    #: of its full slot demand (running a 2-GPU job on one slot is waste)
    min_slot_fraction: float = 0.25
    #: spare-slot GPU-equivalence discount (interleaved offline tokens ride
    #: leftover batch capacity, not dedicated GPUs)
    efficiency: float = 0.85
    #: interference-free NUMA-local service times
    base_tpot_ms: float = 50.0
    base_ttft_ms: float = 400.0
    #: per-class targets as multiples of the base times; defaults clear the
    #: worst Fig. 2 tier (1/0.3125 = 3.2x) so tier degradation alone does
    #: not violate — interference beyond the admission guard does
    tpot_slo: float = 3.5
    ttft_slo: float = 8.0
    #: relative TPOT/TTFT inflation at offline share 1.0
    interference: float = 0.35
    #: admit only while the prediction stays below guard * target
    guard: float = 0.9
    #: sliding SLO window length (ticks) — a tripped replica re-admits only
    #: after a full window of clean samples (hysteresis)
    window: int = 6
    #: consecutive breaches before the monitor trips a replica
    breach_ticks: int = 2

    @property
    def tpot_target_ms(self) -> float:
        return self.base_tpot_ms * self.tpot_slo

    @property
    def ttft_target_ms(self) -> float:
        return self.base_ttft_ms * self.ttft_slo

    @property
    def offline_kv_per_slot(self) -> int:
        return math.ceil(self.seq_len * self.offline_ctx_factor)


# ---- the interference model (shared by prediction AND sampling, so the
# ---- admission guard can never disagree with what the monitor observes) ----

def predicted_tpot_ms(cfg: ElasticConfig, tier_factor: float,
                      offline_share: float) -> float:
    """Decode-step time under tier degradation + offline interference."""
    return cfg.base_tpot_ms / tier_factor * (
        1.0 + cfg.interference * offline_share)


def predicted_ttft_ms(cfg: ElasticConfig, tier_factor: float, load: float,
                      offline_share: float) -> float:
    """First-token time: tier + interference, queueing with online load."""
    return cfg.base_ttft_ms / tier_factor * (
        1.0 + cfg.interference * offline_share) * (1.0 + load)


def max_offline_share(cfg: ElasticConfig, tier_factor: float,
                      load: float) -> float:
    """Largest offline slot share keeping BOTH predictions under
    ``guard * target`` — tier-aware: a degraded replica affords less
    interference headroom, a cross-socket one often none at all."""
    if tier_factor <= 0:
        return 0.0
    s_tpot = (cfg.guard * cfg.tpot_slo * tier_factor - 1.0) / cfg.interference
    s_ttft = ((cfg.guard * cfg.ttft_slo * tier_factor / (1.0 + load) - 1.0)
              / cfg.interference)
    return max(0.0, min(1.0, s_tpot, s_ttft))


class SLOMonitor:
    """Sliding-window per-class TTFT/TPOT monitor with hysteresis.

    ``observe`` feeds one (ttft, tpot) sample per replica per tick;
    ``allowed_share`` is the admission bound the pool enforces.  A replica
    breaches when either metric exceeds its target; ``breach_ticks``
    consecutive breaches trip it (allowed share -> 0, the pool drains it),
    and it recovers only after ``window`` consecutive clean samples — the
    hysteresis that stops a boundary replica from flapping between admit
    and eject every tick.
    """

    def __init__(self, cfg: ElasticConfig) -> None:
        self.cfg = cfg
        self._window: dict[int, deque] = {}      # uid -> recent ok-flags
        self._breach: dict[int, int] = {}        # uid -> consecutive breaches
        self._clean: dict[int, int] = {}         # uid -> consecutive oks
        self._tripped: set[int] = set()
        #: per-class counts since the last ``drain_counts`` (one report row)
        self._counts: dict[str, dict[str, int]] = {}

    def _cls(self, name: str) -> dict[str, int]:
        return self._counts.setdefault(name,
                                       {"ok": 0, "total": 0, "violations": 0})

    def observe(self, cls_name: str, uid: int, ttft_ms: float,
                tpot_ms: float) -> bool:
        cfg = self.cfg
        ok = (tpot_ms <= cfg.tpot_target_ms and ttft_ms <= cfg.ttft_target_ms)
        win = self._window.setdefault(uid, deque(maxlen=cfg.window))
        win.append(ok)
        row = self._cls(cls_name)
        row["total"] += 1
        if ok:
            row["ok"] += 1
            self._breach[uid] = 0
            self._clean[uid] = self._clean.get(uid, 0) + 1
            if uid in self._tripped and self._clean[uid] >= cfg.window:
                self._tripped.discard(uid)
        else:
            row["violations"] += 1
            self._clean[uid] = 0
            self._breach[uid] = self._breach.get(uid, 0) + 1
            if self._breach[uid] >= cfg.breach_ticks:
                self._tripped.add(uid)
        return ok

    def violated(self, uid: int) -> bool:
        """Is the replica currently tripped (being drained)?"""
        return uid in self._tripped

    def allowed_share(self, uid: int, tier_factor: float,
                      load: float) -> float:
        if uid in self._tripped:
            return 0.0                   # drain until a clean window passes
        return max_offline_share(self.cfg, tier_factor, load)

    def forget(self, uid: int) -> None:
        """Drop per-replica state (the replica was scaled down/evicted)."""
        self._window.pop(uid, None)
        self._breach.pop(uid, None)
        self._clean.pop(uid, None)
        self._tripped.discard(uid)

    def drain_counts(self) -> dict[str, dict]:
        """Per-class {ok, total, violations, attainment} since the last
        call — one `ColocationReport` hour row — and reset."""
        out = {}
        for name in sorted(self._counts):
            c = self._counts[name]
            out[name] = dict(c, attainment=(c["ok"] / c["total"]
                                            if c["total"] else 1.0))
        self._counts = {}
        return out


class ReplicaSlots:
    """Slot + KV-cache accounting for ONE online replica.

    ``total_slots = slots_per_gpu * gpus`` continuous-batching slots; the
    KV budget is `configs.shapes.cache_capacity` per slot.  Online traffic
    at load L claims ``ceil(total * L)`` slots; offline requests take whole
    slot grants out of the remainder, each slot carrying the larger
    ``offline_kv_per_slot`` footprint, so KV headroom binds before slot
    headroom.  The achieved-tier factor discounts every service rate.
    """

    def __init__(self, uid: int, cls_name: str, gpus: int,
                 tier_factor: float, cfg: ElasticConfig) -> None:
        self.uid = uid
        self.cls_name = cls_name
        self.gpus = gpus
        self.tier_factor = tier_factor
        self.cfg = cfg
        self.total_slots = cfg.slots_per_gpu * gpus
        self.kv_budget = (cache_capacity(_KVShape(cfg.swa_window), cfg.seq_len)
                         * self.total_slots)
        self.online_slots = 0
        self._synced_load: float | None = None
        self.jobs: dict[int, int] = {}       # jid -> granted slots

    @property
    def offline_slots(self) -> int:
        return sum(self.jobs.values())

    def offline_share(self) -> float:
        return self.offline_slots / self.total_slots if self.total_slots else 0.0

    def set_load(self, load: float) -> None:
        self._synced_load = load
        self.online_slots = min(self.total_slots,
                                math.ceil(self.total_slots * load))

    def sync_load(self, load: float) -> None:
        """Lazily apply the pool's current load.  ``online_slots`` is a
        pure function of (total_slots, load), so a replica untouched since
        the last load change recomputes it on first access instead of the
        pool eagerly updating every replica per tick."""
        if self._synced_load != load:
            self.set_load(load)

    def kv_headroom_slots(self) -> int:
        """Offline slot grants the remaining KV budget can still hold."""
        used = (self.online_slots * self.cfg.seq_len
                + self.offline_slots * self.cfg.offline_kv_per_slot)
        return max(0, (self.kv_budget - used) // self.cfg.offline_kv_per_slot)

    def _permitted_offline(self, allowed_share: float) -> int:
        """Offline slots this replica may hold in total right now."""
        by_kv = max(0, (self.kv_budget - self.online_slots * self.cfg.seq_len)
                    // self.cfg.offline_kv_per_slot)
        return max(0, min(self.total_slots - self.online_slots,
                          math.floor(allowed_share * self.total_slots),
                          by_kv))

    def spare_slots(self, allowed_share: float) -> int:
        """Slots an admission could still grant under the SLO bound."""
        return max(0, self._permitted_offline(allowed_share)
                   - self.offline_slots)

    def overflow_slots(self, allowed_share: float) -> int:
        """Offline slots that must be ejected to get back under the bound."""
        return max(0, self.offline_slots
                   - self._permitted_offline(allowed_share))

    def rate(self, slots: int, job_gpus: int) -> float:
        """Progress rate (fraction of a dedicated full-rate instance) of an
        offline job granted ``slots`` here: slot share of its full demand,
        discounted by spare-slot efficiency and the achieved tier."""
        full = self.cfg.slots_per_gpu * job_gpus
        return min(1.0, slots / full) * self.cfg.efficiency * self.tier_factor


class ElasticPool:
    """Level-1 admission controller over all online replicas' spare slots.

    Deterministic throughout: replicas are scanned in uid order, ejections
    evict the youngest grants first (highest jid — the most recently
    admitted request has made the least progress), and every decision is a
    pure function of (replica state, monitor state, load).
    """

    def __init__(self, cfg: ElasticConfig, monitor: SLOMonitor) -> None:
        self.cfg = cfg
        self.monitor = monitor
        self.replicas: dict[int, ReplicaSlots] = {}
        self._host: dict[int, int] = {}          # jid -> replica uid
        self.load = 0.0

    # ---- replica lifecycle ----------------------------------------------------------
    def register(self, uid: int, cls_name: str, gpus: int,
                 tier_factor: float) -> ReplicaSlots:
        rs = ReplicaSlots(uid, cls_name, gpus, tier_factor, self.cfg)
        rs.set_load(self.load)
        self.replicas[uid] = rs
        return rs

    def unregister(self, uid: int) -> list[int]:
        """Drop a replica (scaled down / evicted); returns the hosted jids
        the caller must eject back to its pending queue."""
        rs = self.replicas.pop(uid, None)
        if rs is None:
            return []
        self.monitor.forget(uid)
        out = sorted(rs.jobs, reverse=True)
        for jid in out:
            del self._host[jid]
        rs.jobs.clear()
        return out

    # ---- load / SLO reclaim (degrade-before-kill, step 1) ---------------------------
    def set_load(self, load: float) -> list[int]:
        """Online traffic reclaims its slots: record the new load (every
        replica picks it up lazily via ``sync_load`` on next access) and
        eject offline grants that no longer fit under the slot / KV / SLO
        bounds.  Only replicas actually HOSTING grants are walked — a
        replica without jobs has nothing to eject, so the reclaim pass is
        O(changed replicas), not O(fleet).  Returns ejected jids in the
        same deterministic order the full scan produced."""
        self.load = load
        ejected: list[int] = []
        for uid in sorted(set(self._host.values())):
            rs = self.replicas[uid]
            rs.sync_load(load)
            allowed = self.monitor.allowed_share(uid, rs.tier_factor, load)
            while rs.overflow_slots(allowed) > 0 and rs.jobs:
                jid = max(rs.jobs)           # youngest grant first
                del rs.jobs[jid]
                del self._host[jid]
                ejected.append(jid)
        return ejected

    # ---- admission ------------------------------------------------------------------
    def admit(self, jid: int, job_gpus: int) -> tuple[int, int, float] | None:
        """Try to place one offline request: pick the replica with the most
        spare slots under its SLO bound (tie: lowest uid) and grant up to
        the request's full slot demand.  Returns ``(replica uid, slots,
        rate)`` or None if no replica clears ``min_slot_fraction``."""
        need = self.cfg.slots_per_gpu * job_gpus
        min_slots = max(1, math.ceil(need * self.cfg.min_slot_fraction))
        best: ReplicaSlots | None = None
        best_spare = 0
        for uid in sorted(self.replicas):
            rs = self.replicas[uid]
            rs.sync_load(self.load)
            spare = rs.spare_slots(
                self.monitor.allowed_share(uid, rs.tier_factor, self.load))
            if spare > best_spare:
                best, best_spare = rs, spare
        if best is None or best_spare < min_slots:
            return None
        slots = min(best_spare, need)
        best.jobs[jid] = slots
        self._host[jid] = best.uid
        return best.uid, slots, best.rate(slots, job_gpus)

    def release(self, jid: int) -> None:
        """An elastic request finished; free its grant (tolerates a replica
        that was already unregistered)."""
        uid = self._host.pop(jid, None)
        if uid is not None and uid in self.replicas:
            self.replicas[uid].jobs.pop(jid, None)

    def host_of(self, jid: int) -> int | None:
        return self._host.get(jid)

    def hosted(self) -> int:
        return len(self._host)

    def spare_total(self) -> int:
        for rs in self.replicas.values():
            rs.sync_load(self.load)
        return sum(
            rs.spare_slots(self.monitor.allowed_share(uid, rs.tier_factor,
                                                      self.load))
            for uid, rs in sorted(self.replicas.items()))

    # ---- observation ----------------------------------------------------------------
    def sample(self, load: float) -> None:
        """Push one deterministic SLO sample per replica through the
        monitor — the SAME interference model the admission guard predicts
        with, so a grant the guard allowed can only breach through tier
        degradation or an external load jump, never by construction."""
        for uid in sorted(self.replicas):
            rs = self.replicas[uid]
            share = rs.offline_share()
            self.monitor.observe(
                rs.cls_name, uid,
                predicted_ttft_ms(self.cfg, rs.tier_factor, load, share),
                predicted_tpot_ms(self.cfg, rs.tier_factor, share))
