"""KWOK-analogue cluster simulator (paper §5).

Reproduces the paper's experimental protocol without a Kubernetes control
plane: N simulated GPU servers, Table 3 workloads, *saturation allocation*
(§3.1) as the initial condition, then auto-scaling events that trigger
preemptive scheduling.

The initial saturation uses seeded random placement (largest-GPU-first so the
divisible instance sizes always pack) with random GPU/CoreGroup bit choice —
this mirrors the fragmented "before" state of the paper's Fig. 8 snapshot
produced by a topology-unaware default scheduler.  ``saturate`` draws from
its ``random.Random`` in exactly the order the reference does, so one seed
builds the same cluster in both packages.

``SimConfig.device`` is the device the clusters' kernels run on: the GPU
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
import random
import time

import numpy as np

from .cluster import Cluster
from .placement import Placement
from .scheduler import EngineName, TopoScheduler
from .topology import RTX4090_SERVER, ServerSpec
from .workload import (TABLE3_INITIAL_INSTANCES, WorkloadSpec,
                       table3_workloads)


@dataclasses.dataclass
class SimConfig:
    num_nodes: int = 100
    spec: ServerSpec = RTX4090_SERVER
    seed: int = 0
    alpha: float = 0.5
    device: str = "cuda"


class CompileWatch:
    """Counts compiles inside timed regions so samples that paid one can be
    tagged.  Nothing in this package compiles at plan time (the CUDA kernels
    are built once, before the first launch), so every delta reads 0."""

    _installed: "CompileWatch | None" = None

    def __init__(self) -> None:
        self.count = 0

    @classmethod
    def get(cls) -> "CompileWatch":
        if cls._installed is None:
            cls._installed = cls()
        return cls._installed

    def mark(self) -> int:
        return self.count

    def delta(self, mark: int) -> int:
        return self.count - mark


@dataclasses.dataclass
class HitRateReport:
    engine: str
    preemptions: int = 0
    hits: int = 0
    failures: int = 0          # no feasible candidate found
    placements: int = 0        # normal-cycle (non-preemptive) outcomes
    sourcing_us: list[float] = dataclasses.field(default_factory=list)
    #: aligned with ``sourcing_us``: True where the timed region compiled
    compiled: list[bool] = dataclasses.field(default_factory=list)
    #: one ``(kind, node, victims, tier, hit)`` per evaluated decision, in
    #: protocol order — what decision parity between engines compares
    decision_keys: list[tuple] = dataclasses.field(default_factory=list)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.preemptions if self.preemptions else 0.0

    @property
    def compiled_samples(self) -> int:
        return sum(self.compiled)

    @property
    def decisions(self) -> int:
        """Every evaluated outcome: placed + preempted + rejected."""
        return self.placements + self.preemptions + self.failures

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.sourcing_us, q)) if self.sourcing_us else 0.0


def decision_key(dec) -> tuple:
    """``(kind, node, victims, tier, hit)`` of one `SchedulingDecision`."""
    return (dec.kind, dec.node, tuple(dec.victims),
            None if dec.placement is None else dec.placement.tier,
            bool(dec.hit))


def _random_bits(rng: random.Random, mask: int, k: int, n: int) -> int:
    free = [i for i in range(n) if mask >> i & 1]
    picked = rng.sample(free, k)
    out = 0
    for i in picked:
        out |= 1 << i
    return out


def _aligned_random_placement(
    cluster: Cluster, node: int, wl: WorkloadSpec, rng: random.Random,
    sequential_prob: float = 0.5,
) -> Placement | None:
    """Kubelet-style placement: each GPU paired with a local CoreGroup
    (CPU↔GPU locality guaranteed at admission) but NUMA/socket choice random —
    reproduces the fragmented-yet-locally-aligned 'before' state of Fig. 8.

    ``sequential_prob`` is the probability this instance fills NUMA nodes in
    index order (real schedulers deploy replicas in bursts that pack
    sequentially) vs. fully shuffled — it calibrates the fragmentation entropy
    of the initial state, which the paper does not fully specify.
    """
    spec = cluster.spec
    need_gpus = wl.gpus_per_instance
    need_cgs = wl.coregroups_per_instance(spec.coregroup_size)
    cgs_per_bundle = need_cgs // need_gpus if need_gpus else 0
    free_gpu, free_cg = cluster.free_masks(node)
    gpu_mask = 0
    cg_mask = 0
    numas = list(range(spec.num_numa))
    if rng.random() >= sequential_prob:
        rng.shuffle(numas)
    remaining = need_gpus
    for u in numas * max(1, spec.gpus_per_numa):
        if remaining == 0:
            break
        ug = free_gpu & int(spec.numa_gpu_masks[u]) & ~gpu_mask
        uc = free_cg & int(spec.numa_cg_masks[u]) & ~cg_mask
        if ug and uc.bit_count() >= cgs_per_bundle:
            g = (ug & -ug).bit_length() - 1   # lowest free GPU in this NUMA
            gpu_mask |= 1 << g
            taken = 0
            for c in range(spec.num_coregroups):
                if taken == cgs_per_bundle:
                    break
                if uc >> c & 1:
                    cg_mask |= 1 << c
                    taken += 1
            remaining -= 1
    if remaining:
        return None
    # leftover CoreGroups beyond whole bundles from anywhere free
    extra = need_cgs - cg_mask.bit_count()
    if extra:
        avail = free_cg & ~cg_mask
        if avail.bit_count() < extra:
            return None
        cg_mask |= _random_bits(rng, avail, extra, spec.num_coregroups)
    return Placement(gpu_mask=gpu_mask, cg_mask=cg_mask, tier=0)


def saturate(
    cluster: Cluster,
    workloads: list[WorkloadSpec],
    counts: dict[str, int],
    rng: random.Random,
    aligned: bool = True,
) -> None:
    """Fill the cluster to 100% GPU allocation with fragmented placement.

    ``aligned=True`` (default, matches the paper's production baseline) keeps
    per-GPU CPU locality but randomizes NUMA/socket spread; ``aligned=False``
    is the fully blind ablation.
    """
    spec = cluster.spec
    for wl in sorted(workloads, key=lambda w: -w.gpus_per_instance):
        need_cgs = wl.coregroups_per_instance(spec.coregroup_size)
        for _ in range(counts.get(wl.name, 0)):
            feasible = []
            for node in range(cluster.num_nodes):
                fg, fc = cluster.free_masks(node)
                if (fg.bit_count() >= wl.gpus_per_instance
                        and fc.bit_count() >= need_cgs):
                    feasible.append(node)
            if not feasible:
                raise RuntimeError(
                    f"saturation failed: no node fits {wl.name} "
                    f"({wl.gpus_per_instance} GPUs)"
                )
            placement = None
            node = -1
            if aligned:
                for node in rng.sample(feasible, len(feasible)):
                    placement = _aligned_random_placement(cluster, node, wl, rng)
                    if placement is not None:
                        break
            if placement is None:
                node = rng.choice(feasible)
                fg, fc = cluster.free_masks(node)
                placement = Placement(
                    gpu_mask=_random_bits(rng, fg, wl.gpus_per_instance,
                                          spec.num_gpus),
                    cg_mask=_random_bits(rng, fc, need_cgs, spec.num_coregroups),
                    tier=0,
                )
            cluster.bind(wl, node, placement)


def build_saturated_cluster(cfg: SimConfig,
                            workloads: list[WorkloadSpec] | None = None,
                            counts: dict[str, int] | None = None) -> Cluster:
    workloads = workloads or table3_workloads()
    if counts is None:
        # scale Table 3's 100-node counts to cfg.num_nodes
        scale = cfg.num_nodes / 100.0
        counts = {k: max(0, round(v * scale))
                  for k, v in TABLE3_INITIAL_INSTANCES.items()}
        # rounding may oversubscribe GPUs on small clusters: trim the
        # lowest-priority workloads until the mix fits
        by_gpus = {w.name: w.gpus_per_instance for w in workloads}
        capacity = cfg.num_nodes * cfg.spec.num_gpus
        order = sorted(workloads, key=lambda w: w.priority)
        while sum(counts[k] * by_gpus[k] for k in counts) > capacity:
            for w in order:
                if counts.get(w.name, 0) > 0:
                    counts[w.name] -= 1
                    break
    cluster = Cluster(cfg.spec, cfg.num_nodes, device=cfg.device)
    saturate(cluster, workloads, counts, random.Random(cfg.seed))
    return cluster


# ---------------------------------------------------------------------------------
# Experiments
# ---------------------------------------------------------------------------------

def run_hit_rate_experiment(
    cfg: SimConfig,
    engine: EngineName,
    cycles: int = 100,
    scaleups_per_cycle: int = 50,
    preemptor_names: tuple[str, ...] = ("B", "C"),
    independent: bool = True,
) -> HitRateReport:
    """Paper Table 4: cycles × scale-ups, hit-rate of topology affinity.

    ``independent=True`` follows the paper's protocol ("for each instance
    scaled up, the candidate sourcing and victim selection processes are
    evaluated independently"): every scale-up is *planned* against the
    cycle's saturated state and never committed — a rollback-free read of
    the transactional API.  ``independent=False`` commits scale-ups
    sequentially (capacity depletes within a cycle).
    """
    report = HitRateReport(engine=engine)
    workloads = {w.name: w for w in table3_workloads()}
    for cycle in range(cycles):
        cluster = build_saturated_cluster(
            dataclasses.replace(cfg, seed=cfg.seed + cycle))
        sched = TopoScheduler(cluster, engine=engine, alpha=cfg.alpha)
        rng = random.Random(10_000 + cfg.seed + cycle)
        for _ in range(scaleups_per_cycle):
            wl = workloads[rng.choice(preemptor_names)]
            txn = sched.plan(wl)
            dec = txn.commit() if not independent else txn.decision
            report.decision_keys.append(decision_key(dec))
            if dec.preempted:
                report.preemptions += 1
                report.hits += int(dec.hit)
                report.sourcing_us.append(dec.sourcing_us)
            elif dec.rejected:
                report.failures += 1
            else:
                # Table 4's hit rate is over preemptions only, but placed
                # outcomes are still counted so the independent and
                # committed protocols report the same decision totals
                report.placements += 1
    return report


def run_latency_experiment(
    cfg: SimConfig,
    engine: EngineName,
    preemptor_name: str,
    samples: int = 50,
) -> HitRateReport:
    """Paper Table 5: candidate-sourcing latency for one preemptor class."""
    report = HitRateReport(engine=engine)
    workloads = {w.name: w for w in table3_workloads()}
    wl = workloads[preemptor_name]
    cycle = 0
    while len(report.sourcing_us) < samples:
        cluster = build_saturated_cluster(
            dataclasses.replace(cfg, seed=cfg.seed + cycle))
        sched = TopoScheduler(cluster, engine=engine, alpha=cfg.alpha)
        watch = CompileWatch.get()
        for _ in range(min(samples - len(report.sourcing_us), 10)):
            m = watch.mark()
            dec = sched.schedule_or_preempt(wl)
            report.decision_keys.append(decision_key(dec))
            if dec.preempted:
                report.preemptions += 1
                report.hits += int(dec.hit)
                report.sourcing_us.append(dec.sourcing_us)
                report.compiled.append(watch.delta(m) > 0)
            elif dec.rejected:
                report.failures += 1
                break
            else:
                report.placements += 1
        cycle += 1
        if cycle > samples:  # safety: cannot source enough preemptions
            break
    return report


def run_plan_latency_experiment(
    cfg: SimConfig,
    engine: EngineName,
    preemptor_name: str,
    samples: int = 50,
) -> HitRateReport:
    """Filtering-INCLUSIVE end-to-end ``plan()`` latency for one preemptor.

    Unlike `run_latency_experiment` (which reports the engine's own
    sourcing phase), this times the whole transactional ``plan()`` call —
    normal cycle, Guaranteed Filtering, Sorting, and Eq. 2 selection.
    ``sourcing_us`` holds the plan wall times of preempted decisions.
    """
    report = HitRateReport(engine=engine)
    workloads = {w.name: w for w in table3_workloads()}
    wl = workloads[preemptor_name]
    cycle = 0
    while len(report.sourcing_us) < samples:
        cluster = build_saturated_cluster(
            dataclasses.replace(cfg, seed=cfg.seed + cycle))
        sched = TopoScheduler(cluster, engine=engine, alpha=cfg.alpha)
        watch = CompileWatch.get()
        for _ in range(min(samples - len(report.sourcing_us), 10)):
            m = watch.mark()
            t0 = time.perf_counter()
            txn = sched.plan(wl)
            plan_us = (time.perf_counter() - t0) * 1e6
            dec = txn.commit()
            report.decision_keys.append(decision_key(dec))
            if dec.preempted:
                report.preemptions += 1
                report.hits += int(dec.hit)
                report.sourcing_us.append(plan_us)
                report.compiled.append(watch.delta(m) > 0)
            elif dec.rejected:
                report.failures += 1
                break
            else:
                report.placements += 1
        cycle += 1
        if cycle > samples:  # safety: cannot source enough preemptions
            break
    return report
