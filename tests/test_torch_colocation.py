"""The co-location day cycle of the port (``repro_torch.core.colocation``
with ``autoscale``, ``agent`` and the rest of ``simulator``), held against
the JAX package's day and against the committed ``BENCH_colocation.json``.

Every port object is built with ``device="cpu"``, where the fused
``imp_batched`` engine runs each kernel's plain PyTorch version.  The
oracles are the reference's host ``imp`` and ``godel`` days: the
reference's own live ``imp_batched`` is not one on jax 0.9.0 (its
baked-request normal cycle miscompiles, ROADMAP R1), so the port's
``imp_batched`` is held to the reference's ``imp``.  The committed day runs
``imp_batched`` at the committed 24 nodes (~10 s on a CPU).  Besides, the
port of ``tests/test_colocation.py``: the requeue lifecycle, determinism,
the O(delta) loop against ``legacy_loop=True``, event-order invariance,
the autoscaler's index, worst-tier scale-downs, chunked backfill, the Fig.
8/9 views and the latency protocols, and `TopoScheduler`'s shortlist and
``auto_threshold`` arguments.
"""
import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.core import colocation as ref_coloc  # noqa: E402
from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.scheduler import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.cluster import Cluster as RefCluster  # noqa: E402
from repro.core.topology import RTX4090_SERVER as REF_RTX  # noqa: E402
from repro.core.autoscale import Autoscaler as RefAutoscaler  # noqa: E402
from repro.core.autoscale import \
    AutoscalePolicy as RefAutoscalePolicy  # noqa: E402
from repro.core.workload import \
    table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (RTX4090_SERVER, Cluster,  # noqa: E402
                              ColocationConfig, ColocationSim, TopoScheduler,
                              UnknownEngineError, compare_day_cycle,
                              registered_engines, run_day_cycle)
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.autoscale import (AutoscalePolicy,  # noqa: E402
                                        Autoscaler)
from repro_torch.core.colocation import _SUBMIT, default_policies  # noqa: E402
from repro_torch.core.placement import achieved_tier  # noqa: E402
from repro_torch.core.scheduler import ShortlistConfig  # noqa: E402
from repro_torch.core.workload import table3_workloads  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}

#: the deterministic fields of one ``BENCH_colocation.json`` engine entry
BENCH_FIELDS = ("scheduled_perf", "preemptor_perf", "offline_goodput",
                "hit_rate", "hits", "preemptions", "placements", "failures",
                "requeued", "requeue_replanned", "requeue_success_rate")


def port_cfg(**kw) -> ColocationConfig:
    return ColocationConfig(device="cpu", **kw)


def day(engine: str, num_nodes: int = 12, horizon: float = 24.0,
        seed: int = 0):
    cfg = port_cfg(num_nodes=num_nodes, seed=seed, engine=engine,
                   horizon_hours=horizon)
    s = ColocationSim(cfg, policies=default_policies(cfg))
    return s, s.run()


def ref_metrics(engine: str, **kw) -> dict:
    cfg = ref_coloc.ColocationConfig(engine=engine, **kw)
    return ref_coloc.run_day_cycle(cfg).key_metrics()


def without_engine(km: dict) -> dict:
    return {k: v for k, v in km.items() if k != "engine"}


# ---- day parity against the reference ----------------------------------------------

@pytest.mark.parametrize("horizon", [8.0, 12.0])
@pytest.mark.parametrize("engine,ref_engine", [
    ("imp", "imp"), ("godel", "godel"), ("imp_batched", "imp")])
def test_day_parity_with_reference(engine, ref_engine, horizon):
    """``key_metrics()`` — every day total and every hour row without its
    latency fields — equal to the reference's, float for float."""
    kw = dict(num_nodes=8, seed=0, horizon_hours=horizon)
    got = run_day_cycle(port_cfg(engine=engine, **kw)).key_metrics()
    want = ref_metrics(ref_engine, **kw)
    assert got["engine"] == engine
    assert without_engine(got) == without_engine(want)
    assert got["preemptions"] > 0 and got["completed_jobs"] > 0
    assert len(got["hours"]) == int(horizon)


@pytest.mark.parametrize("aware", ["imp", "imp_batched"])
def test_committed_day_matches_bench(aware):
    """The committed A/B (``benchmarks/bench_colocation.py:day_config``: 24
    nodes x 24 h, seed 0, warm-up on): every deterministic field of both
    ``BENCH_colocation.json`` engine entries and the three uplifts.  The
    committed aware engine is ``imp_batched``; host ``imp`` makes the same
    decisions."""
    bench = json.loads((ROOT / "BENCH_colocation.json").read_text())
    cfg = port_cfg(num_nodes=bench["num_nodes"], seed=bench["seed"],
                   horizon_hours=bench["horizon_hours"], warmup=True)
    ab = compare_day_cycle(cfg, engines=(aware, "godel"))
    for name, want in (("imp_batched", aware), ("godel", "godel")):
        rep = ab["reports"][want]
        for field in BENCH_FIELDS:
            assert getattr(rep, field) == bench["engines"][name][field], \
                (name, field)
    for field in ("uplift", "preemptor_uplift", "goodput_uplift"):
        assert ab[field] == bench[field], field
    assert ab["reports"][aware].requeue_replanned == 22


# ---- victim requeue lifecycle ------------------------------------------------------

def test_requeue_round_trip_preserves_identity_and_uids():
    """preempt -> requeue -> replan keeps the job's workload identity and
    NEVER resurrects an evicted instance uid."""
    s, rep = day("imp")
    assert rep.preemptions > 0 and rep.requeued > 0
    assert rep.requeue_replanned > 0
    requeued = [j for j in s.jobs if j.requeues > 0]
    assert requeued
    for job in requeued:
        assert len(job.uids) == len(set(job.uids)) >= 1
        if len(job.uids) > 1:
            assert list(job.uids) == sorted(job.uids)
        assert job.workload.name in ("C", "D")
        assert job.workload == WL3[job.workload.name]
        if job.uid is not None:
            assert job.uid == job.uids[-1]
            assert s.cluster.instances[job.uid].workload == job.workload
            for stale in job.uids[:-1]:
                assert stale not in s.cluster.instances


def test_requeue_preserves_remaining_work():
    s, _ = day("imp")
    done = [j for j in s.jobs if j.requeues and j.completed_at is not None]
    assert done
    for job in done:
        assert job.completed_at - job.submitted_at > job.duration_hours


def test_requeue_disabled_drops_victims():
    cfg = port_cfg(num_nodes=12, seed=0, engine="imp", requeue=False)
    rep = ColocationSim(cfg, policies=default_policies(cfg)).run()
    assert rep.requeued > 0
    assert rep.requeue_replanned == 0
    assert without_engine(rep.key_metrics()) == without_engine(
        ref_metrics("imp", num_nodes=12, seed=0, requeue=False))


# ---- determinism and accounting ----------------------------------------------------

@pytest.mark.parametrize("engine", ["imp", "imp_batched"])
def test_day_cycle_metrics_deterministic(engine):
    _, a = day(engine, num_nodes=8, horizon=12.0)
    _, b = day(engine, num_nodes=8, horizon=12.0)
    assert a.key_metrics() == b.key_metrics()


def test_day_cycle_seed_changes_day():
    _, a = day("imp", num_nodes=8, horizon=12.0, seed=0)
    _, b = day("imp", num_nodes=8, horizon=12.0, seed=7)
    assert a.key_metrics() != b.key_metrics()
    assert without_engine(b.key_metrics()) == without_engine(
        ref_metrics("imp", num_nodes=8, seed=7, horizon_hours=12.0))


def test_scheduled_perf_positive_and_bounded():
    s, rep = day("imp", num_nodes=8, horizon=12.0)
    assert 0 < rep.scheduled_perf <= 8 * s.cluster.spec.num_gpus * 12.0
    assert rep.offline_goodput > 0
    for row in rep.hours:
        assert set(row.served) <= {"A", "B", "C", "D"}
        assert row.scheduled_perf == pytest.approx(sum(
            v for k, v in row.served.items() if k in ("A", "B")))


def test_report_plan_latency_excluded_from_key_metrics():
    _, rep = day("imp", num_nodes=8, horizon=6.0)
    row = rep.hours[0]
    for field in ("plan_p50_us", "compiled_n"):
        assert field not in row.key_metrics()
        assert field in dataclasses.asdict(row)
    assert all(r.compiled_n == 0 for r in rep.hours)
    assert rep.plan_p50_us > 0


# ---- the O(delta) event loop -------------------------------------------------------

@pytest.mark.parametrize("elastic", [False, True])
def test_legacy_loop_parity(elastic):
    """The O(delta) loop bit-exact against ``legacy_loop=True`` (with and
    without the two-level ladder), both equal to the reference's day, and
    both popping the same event stream."""
    kw = dict(num_nodes=10, seed=0, horizon_hours=10.0, elastic=elastic)
    runs = {}
    for legacy in (False, True):
        cfg = port_cfg(engine="imp", legacy_loop=legacy, **kw)
        s = ColocationSim(cfg, policies=default_policies(cfg))
        runs[legacy] = (s, s.run().key_metrics())
    (s_new, new), (s_old, old) = runs[False], runs[True]
    assert new == old
    assert s_new.events_processed == s_old.events_processed > 0
    assert new["preemptions"] > 0 and new["completed_jobs"] > 0
    if elastic:
        assert new["elastic_admitted"] > 0
    assert new == ref_metrics("imp", **kw)


def test_event_order_invariance():
    """Day metrics are invariant to the ORDER same-timestamp events were
    pushed in (the heap's per-kind jid/uid sort key)."""

    class ReorderedSim(ColocationSim):
        def _generate_offline_arrivals(self):
            buffered = []
            orig_push = self._push

            def buffering_push(t, kind, payload):
                if kind == _SUBMIT:
                    buffered.append((t, payload))
                else:
                    orig_push(t, kind, payload)

            self._push = buffering_push
            try:
                super()._generate_offline_arrivals()
            finally:
                del self._push
            for t, payload in reversed(buffered):
                self._push(t, _SUBMIT, payload)

    cfg = port_cfg(num_nodes=10, seed=0, engine="imp", horizon_hours=10.0)
    straight = ColocationSim(cfg, policies=default_policies(cfg)).run()
    shuffled = ReorderedSim(cfg, policies=default_policies(cfg)).run()
    assert straight.key_metrics() == shuffled.key_metrics()


@pytest.mark.parametrize("engine", ["imp", "imp_batched"])
def test_autoscaler_index_matches_cluster_scan(engine):
    """The listener-maintained replica/tier/GPU index equals a fresh scan
    after a day of binds, evicts and restores; with ``imp_batched`` every
    plan of the day is a fused plan, counted by kind at the scheduler."""
    s, _ = day(engine, num_nodes=8, horizon=8.0)
    cluster, auto = s.cluster, s.auto
    assert auto.used_gpus == sum(i.workload.gpus_per_instance
                                 for i in cluster.instances.values())
    by_class = {}
    for uid, inst in cluster.instances.items():
        by_class.setdefault(inst.workload.name, []).append(uid)
    for name, uids in by_class.items():
        assert [i.uid for i in auto.replicas(name)] == sorted(uids)
    for uid, inst in cluster.instances.items():
        assert auto._tier[uid] == achieved_tier(cluster.spec, inst.gpu_mask)
    counts = s.sched.plan_counts
    if engine == "imp_batched":
        assert counts["normal_only"] > counts["may_preempt"] > 0
        assert sum(counts.values()) == len(s.sched.sourcing_us_log)
        # the scale executor's padded plans are planned, never recorded
        assert sum(counts.values()) >= len(auto.plan_us)
    else:
        assert counts == {"normal_only": 0, "may_preempt": 0}


# ---- autoscaler satellites ---------------------------------------------------------

def _fragmented_b(cluster_cls, spec, sched_cls, wl3):
    """Two B replicas, four D blockers, then a third B forced onto a
    degraded placement (the reference test's set-up)."""
    cluster = cluster_cls(spec, 2, **({"device": "cpu"}
                                      if cluster_cls is Cluster else {}))
    sched = sched_cls(cluster, engine="imp")
    for _ in range(2):
        assert sched.schedule(wl3["B"]).placed
    for _ in range(4):
        assert sched.schedule(wl3["D"]).placed
    assert sched.schedule(wl3["B"]).placed
    return cluster, sched


def test_scale_down_evicts_worst_tier_first():
    cluster, sched = _fragmented_b(Cluster, RTX4090_SERVER, TopoScheduler,
                                   WL3)
    spec = cluster.spec
    tiers = {uid: achieved_tier(spec, inst.gpu_mask)
             for uid, inst in cluster.instances.items()
             if inst.workload.name == "B"}
    worst = max(tiers.values())
    ev = Autoscaler(cluster, sched, []).scale_to(
        AutoscalePolicy(WL3["B"], 0, 3), want=2)
    assert ev.action == "scale_down"
    assert ev.reclaimed_tiers == {worst: 1}
    assert all(achieved_tier(spec, i.gpu_mask) <= worst
               for i in cluster.instances.values() if i.workload.name == "B")
    rc, rs = _fragmented_b(RefCluster, REF_RTX, RefScheduler, REF_WL3)
    ref_ev = RefAutoscaler(rc, rs, []).scale_to(
        RefAutoscalePolicy(REF_WL3["B"], 0, 3), want=2)
    assert dataclasses.asdict(ev) == dataclasses.asdict(ref_ev)
    assert sorted(cluster.instances) == sorted(rc.instances)


@pytest.mark.parametrize("engine", ["imp", "imp_batched"])
def test_backfill_chunked_admission_fills_and_stops(engine):
    cluster = Cluster(RTX4090_SERVER, 2, device="cpu")
    sched = TopoScheduler(cluster, engine=engine)
    auto = Autoscaler(cluster, sched, [], backfill=WL3["D"], backfill_chunk=4)
    admitted, rejected = auto.backfill_valleys()
    assert admitted == 2 * cluster.spec.num_gpus     # D is 1 GPU / instance
    assert rejected > 0
    again, rejected = auto.backfill_valleys()
    assert again == 0 and rejected == 4
    # one plan_us entry a planned (unpadded) request
    assert len(auto.plan_us) == 4 * 5 + 4


@pytest.mark.parametrize("engine", ["imp", "imp_batched"])
def test_autoscale_event_counts_normal_placements(engine):
    cluster = Cluster(RTX4090_SERVER, 4, device="cpu")
    sched = TopoScheduler(cluster, engine=engine)
    ev = Autoscaler(cluster, sched, []).scale_to(
        AutoscalePolicy(WL3["B"], 0, 4), want=3)
    assert ev.action == "scale_up"
    assert ev.placements == 3 and ev.preemptions == 0 and ev.failures == 0


def test_autoscaler_run_day_matches_reference():
    """The episodic hour loop (``Autoscaler.run_day``) on a saturated
    10-node cluster, event for event against the reference's."""
    events = {}
    for name, build, sched_cls, scaler, policy, wl3 in (
            ("port", sim.build_saturated_cluster, TopoScheduler, Autoscaler,
             AutoscalePolicy, WL3),
            ("ref", ref_sim.build_saturated_cluster, RefScheduler,
             RefAutoscaler, RefAutoscalePolicy, REF_WL3)):
        cfg = (sim.SimConfig(num_nodes=10, seed=4, device="cpu")
               if name == "port" else ref_sim.SimConfig(num_nodes=10, seed=4))
        cluster = build(cfg)
        auto = scaler(cluster, sched_cls(cluster, engine="imp"),
                      [policy(wl3["A"], 1, 3), policy(wl3["B"], 1, 5)],
                      backfill=wl3["D"])
        events[name] = [dataclasses.asdict(e) for e in auto.run_day(2.0)]
    assert events["port"] == events["ref"]
    assert any(e["action"] == "scale_up" for e in events["port"])


# ---- simulator protocols -----------------------------------------------------------

def _counts(rep) -> tuple:
    return (rep.preemptions, rep.hits, rep.failures, rep.placements,
            len(rep.sourcing_us))


@pytest.mark.parametrize("engine", ["imp", "godel", "imp_batched"])
def test_plan_batch_latency_matches_reference(engine):
    rep = sim.run_plan_batch_latency(
        sim.SimConfig(num_nodes=6, seed=2, device="cpu"), engine, "D",
        batch=4, rounds=2)
    assert rep.placements + rep.preemptions + rep.failures == rep.decisions
    assert rep.decisions == 4 * 2
    ref = ref_sim.run_plan_batch_latency(
        ref_sim.SimConfig(num_nodes=6, seed=2),
        "imp" if engine == "imp_batched" else engine, "D", batch=4,
        rounds=2)
    assert _counts(rep) == _counts(ref)


@pytest.mark.parametrize("engine", ["imp", "godel", "imp_batched"])
def test_plan_normal_latency_matches_reference(engine):
    rep = sim.run_plan_normal_latency(
        sim.SimConfig(num_nodes=10, seed=1, device="cpu"), engine, "B",
        samples=5)
    ref = ref_sim.run_plan_normal_latency(
        ref_sim.SimConfig(num_nodes=10, seed=1),
        "imp" if engine == "imp_batched" else engine, "B", samples=5)
    assert rep.placements == 5 and rep.failures == 0
    assert _counts(rep) == _counts(ref)
    assert rep.compiled == [False] * 5


@pytest.mark.parametrize("engine", ["imp", "imp_batched"])
def test_timeline_view_rides_event_loop(engine):
    tl = sim.run_timeline(sim.SimConfig(num_nodes=10, seed=1, device="cpu"),
                          engine=engine, events=[("B", 2), ("A", 1)])
    assert [r["step"] for r in tl] == [0, 1, 2, 3]
    assert tl[2]["B"] == tl[0]["B"] + 2
    ref = ref_sim.run_timeline(ref_sim.SimConfig(num_nodes=10, seed=1),
                               engine="imp", events=[("B", 2), ("A", 1)])
    assert tl == ref


@pytest.mark.parametrize("engine", ["imp", "godel", "imp_batched"])
def test_allocation_snapshot_matches_reference(engine):
    got = sim.run_allocation_snapshot(
        sim.SimConfig(num_nodes=10, seed=0, device="cpu"), engine, churn=8)
    want = ref_sim.run_allocation_snapshot(
        ref_sim.SimConfig(num_nodes=10, seed=0),
        "imp" if engine == "imp_batched" else engine, churn=8)
    assert got["engine"] == engine
    assert without_engine(got) == without_engine(want)
    assert got["preemptions"] > 0


# ---- TopoScheduler's shortlist and auto_threshold arguments ------------------------

@pytest.mark.parametrize("engine", sorted(registered_engines()))
def test_scheduler_shortlist_is_none_on_every_engine(engine):
    """No port engine is registered with ``supports_shortlist`` yet: the
    shortlist stays None, invalid knobs go unvalidated (as in the
    reference for such engines), and the provenance carries 0 / None."""
    cluster = Cluster(RTX4090_SERVER, 3, device="cpu")
    for kw in ({}, {"shortlist_k": 4, "shortlist_mode": "best_effort"},
               {"shortlist_k": 0}, {"shortlist_mode": "bogus"}):
        sched = TopoScheduler(cluster, engine=engine, **kw)
        assert sched.shortlist is None
    dec = TopoScheduler(cluster, engine=engine).plan(WL3["B"]).decision
    prov = dec.sourcing_provenance
    assert prov["engine"] == engine and prov["auto"] is False
    assert prov["shortlist_k"] == 0 and prov["shortlist_mode"] is None
    ref = RefScheduler(RefCluster(REF_RTX, 3), engine="imp",
                       shortlist_mode="bogus")
    assert ref.shortlist is None


def test_shortlist_config_validates():
    assert ShortlistConfig() == ShortlistConfig(k=128, mode="guaranteed")
    with pytest.raises(ValueError, match="positive"):
        ShortlistConfig(k=0)
    with pytest.raises(ValueError, match="mode"):
        ShortlistConfig(mode="bogus")


@pytest.mark.parametrize("threshold,nodes,routes", [
    (None, 8, "imp_batched"), (9, 8, "imp_batched"), (8, 8, None),
    (2, 8, None)])
def test_scheduler_auto_threshold(threshold, nodes, routes):
    cluster = Cluster(RTX4090_SERVER, nodes, device="cpu")
    if routes is None:
        with pytest.raises(UnknownEngineError, match="imp_sharded"):
            TopoScheduler(cluster, engine="auto", auto_threshold=threshold)
        return
    sched = TopoScheduler(cluster, engine="auto", auto_threshold=threshold)
    assert sched.engine == routes
    prov = sched.plan(WL3["B"]).decision.sourcing_provenance
    assert prov["auto"] is True
    assert prov["auto_threshold"] == (4096 if threshold is None
                                      else threshold)
    ref = RefScheduler(RefCluster(REF_RTX, nodes), engine="auto",
                       auto_threshold=threshold)
    assert ref.auto_threshold == sched.auto_threshold


def test_colocation_config_device():
    """``ColocationConfig.device`` names the sim's cluster device; a
    cluster passed in keeps its own."""
    assert ColocationConfig().device == "cuda"
    s = ColocationSim(port_cfg(num_nodes=2, engine="imp"))
    assert s.cluster.device == torch.device("cpu")
    own = Cluster(RTX4090_SERVER, 3, device="cpu")
    s = ColocationSim(ColocationConfig(num_nodes=2, engine="imp"),
                      cluster=own)
    assert s.cluster is own
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ColocationSim(ColocationConfig(num_nodes=2, engine="imp"))
