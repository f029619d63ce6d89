"""The request-level elastic layer of the port (``repro_torch.serving.
elastic``) and the two-level day cycle, held against the JAX package's and
against the committed ``BENCH_elastic.json``.

The port of ``tests/test_elastic.py`` (``ReplicaSlots`` slot/KV accounting
under tier degradation, ``SLOMonitor`` hysteresis, the ladder's
eject-before-preempt ordering, instance demotion ahead of a ramp, the
two-level day's determinism and A/B direction), with each unit's results
also compared to the reference's, plus ``compare_two_level`` at 8 nodes x
12 h against the reference's, both modes field for field (``imp`` and
``imp_batched`` with its plain kernels, ``device="cpu"``), and at the
committed 24 nodes against ``BENCH_elastic.json`` with ``imp``.
"""
import itertools
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.core import colocation as ref_coloc  # noqa: E402
from repro.serving import elastic as ref_el  # noqa: E402
from repro_torch.core.colocation import (ColocationConfig,  # noqa: E402
                                         ColocationSim, compare_two_level,
                                         default_policies, run_day_cycle)
from repro_torch.core.perfmodel import TIER_PERF  # noqa: E402
from repro_torch.serving import (ElasticConfig, ElasticPool,  # noqa: E402
                                 ReplicaSlots, SLOMonitor,
                                 max_offline_share, predicted_tpot_ms,
                                 predicted_ttft_ms)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORST = TIER_PERF[2] / TIER_PERF[0]          # Fig. 2 cross-socket, 0.3125


def two_level_config(**kw) -> ColocationConfig:
    base = dict(num_nodes=8, seed=0, engine="imp", horizon_hours=12.0,
                elastic=True, elastic_cfg=ElasticConfig(), device="cpu")
    base.update(kw)
    return ColocationConfig(**base)


def without_engine(km: dict) -> dict:
    return {k: v for k, v in km.items() if k != "engine"}


# ---- ReplicaSlots accounting -------------------------------------------------------

def test_replica_slots_kv_binds_before_slot_headroom():
    cfg = ElasticConfig()                    # offline_ctx_factor=2.0
    rs = ReplicaSlots(1, "A", 8, 1.0, cfg)
    assert rs.total_slots == cfg.slots_per_gpu * 8
    assert rs.kv_budget == ref_el.ReplicaSlots(
        1, "A", 8, 1.0, ref_el.ElasticConfig()).kv_budget
    rs.set_load(0.5)
    assert rs.online_slots == rs.total_slots // 2
    spare = rs.spare_slots(1.0)
    assert spare == rs.total_slots // 4
    assert spare < rs.total_slots - rs.online_slots
    rs.jobs[7] = spare
    assert rs.spare_slots(1.0) == 0
    assert rs.kv_headroom_slots() == 0
    assert rs.overflow_slots(1.0) == 0
    rs.set_load(1.0)
    assert rs.overflow_slots(1.0) == spare


def test_tier_degradation_shrinks_share_and_rate():
    cfg = ElasticConfig()
    assert max_offline_share(cfg, 1.0, 0.5) == 1.0
    assert max_offline_share(cfg, WORST, 0.5) == 0.0
    full = ReplicaSlots(1, "B", 4, 1.0, cfg)
    degraded = ReplicaSlots(2, "B", 4, WORST, cfg)
    assert degraded.rate(8, 2) == full.rate(8, 2) * WORST
    assert (predicted_tpot_ms(cfg, WORST, 0.5)
            == predicted_tpot_ms(cfg, 1.0, 0.5) / WORST)
    assert (predicted_ttft_ms(cfg, WORST, 0.5, 0.5)
            == predicted_ttft_ms(cfg, 1.0, 0.5, 0.5) / WORST)


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_interference_model_matches_reference(tier):
    """The three prediction functions equal the reference's, float for
    float, over a grid of loads and offline shares at each Fig. 2 tier."""
    cfg, ref_cfg = ElasticConfig(), ref_el.ElasticConfig()
    factor = TIER_PERF[tier]
    for load in (0.0, 0.3, 0.55, 1.0):
        assert (max_offline_share(cfg, factor, load)
                == ref_el.max_offline_share(ref_cfg, factor, load))
        for share in (0.0, 0.25, 1.0):
            assert (predicted_tpot_ms(cfg, factor, share)
                    == ref_el.predicted_tpot_ms(ref_cfg, factor, share))
            assert (predicted_ttft_ms(cfg, factor, load, share)
                    == ref_el.predicted_ttft_ms(ref_cfg, factor, load,
                                                share))


def test_pool_ejects_youngest_grant_first():
    cfg = ElasticConfig()
    pool = ElasticPool(cfg, SLOMonitor(cfg))
    pool.register(1, "A", 8, 1.0)
    assert pool.admit(101, 1) is not None
    assert pool.admit(102, 1) is not None
    ejected = pool.set_load(1.0)             # peak: online reclaims all slots
    assert ejected == [102, 101]             # youngest (highest jid) first
    assert pool.hosted() == 0


def test_pool_admission_matches_reference():
    """A scripted sequence of registrations, loads, admissions, releases
    and samples gives the reference pool's grants, ejections and SLO rows."""
    pools = []
    for mod in (None, ref_el):
        if mod is None:
            cfg = ElasticConfig()
            pool = ElasticPool(cfg, SLOMonitor(cfg))
        else:
            cfg = mod.ElasticConfig()
            pool = mod.ElasticPool(cfg, mod.SLOMonitor(cfg))
        log = []
        for uid, cls, gpus, tier in ((3, "A", 8, 0), (5, "B", 4, 1),
                                     (9, "B", 4, 2)):
            pool.register(uid, cls, gpus, TIER_PERF[tier])
        for step, load in enumerate((0.3, 0.5, 0.2, 0.9, 0.4)):
            log.append(("eject", pool.set_load(load)))
            for jid in range(10 * step, 10 * step + 6):
                log.append(("admit", pool.admit(jid, 1 + jid % 2)))
            pool.release(10 * step + 1)
            pool.sample(load)
            log.append(("spare", pool.spare_total(), pool.hosted()))
        log.append(("unregister", pool.unregister(5)))
        log.append(("slo", pool.monitor.drain_counts()))
        pools.append(log)
    assert pools[0] == pools[1]
    assert any(a == "admit" and g is not None for a, g, *_ in pools[0])


# ---- SLOMonitor hysteresis ---------------------------------------------------------

def test_slo_monitor_trips_after_breach_ticks_and_recovers_after_window():
    cfg = ElasticConfig()                    # breach_ticks=2, window=6
    mon = SLOMonitor(cfg)
    bad = cfg.tpot_target_ms * 2
    ok = cfg.base_tpot_ms
    uid = 5
    assert not mon.observe("A", uid, ok, bad)
    assert not mon.violated(uid), "one breach must not trip"
    assert mon.allowed_share(uid, 1.0, 0.2) > 0
    mon.observe("A", uid, ok, bad)
    assert mon.violated(uid), "breach_ticks consecutive breaches trip"
    assert mon.allowed_share(uid, 1.0, 0.2) == 0.0
    for _ in range(cfg.window - 1):
        mon.observe("A", uid, ok, ok)
        assert mon.violated(uid)
    mon.observe("A", uid, ok, ok)
    assert not mon.violated(uid), "full clean window recovers"
    counts = mon.drain_counts()["A"]
    assert counts["violations"] == 2
    assert counts["total"] == 2 + cfg.window
    assert counts["ok"] == cfg.window
    assert mon.drain_counts() == {}, "drain resets the row"


def test_breach_interrupted_by_clean_sample_does_not_trip():
    cfg = ElasticConfig()
    mon = SLOMonitor(cfg)
    bad, ok = cfg.tpot_target_ms * 2, cfg.base_tpot_ms
    mon.observe("A", 1, ok, bad)
    mon.observe("A", 1, ok, ok)              # resets the breach run
    mon.observe("A", 1, ok, bad)
    assert not mon.violated(1)


# ---- the two-level ladder in the day cycle -----------------------------------------

def test_peak_ramp_ejects_requests_before_preempting_instances():
    """Reversed ladder: within every tick, request-level ejection
    (`pool.set_load`) runs before the scale executor can preempt."""
    cfg = two_level_config()
    s = ColocationSim(cfg, policies=default_policies(cfg))
    order: list[tuple[float, str]] = []
    pool_set_load, scale_to = s.pool.set_load, s.auto.scale_to

    def spy_set_load(load):
        order.append((s._now, "a_eject"))
        return pool_set_load(load)

    def spy_scale_to(pol, want, hour=0.0):
        order.append((s._now, "b_scale"))
        return scale_to(pol, want, hour)

    s.pool.set_load = spy_set_load
    s.auto.scale_to = spy_scale_to
    rep = s.run()
    assert rep.elastic_admitted > 0, "scenario must exercise the pool"
    ticks = 0
    for _, group in itertools.groupby(order, key=lambda e: e[0]):
        kinds = [k for _, k in group]
        if "a_eject" in kinds and "b_scale" in kinds:
            ticks += 1
            assert kinds == sorted(kinds), \
                "ejection must precede the scale executor in a tick"
    assert ticks > 0


def test_ramp_demotes_instances_instead_of_preempting():
    ab = compare_two_level(ColocationConfig(num_nodes=8, seed=0, engine="imp",
                                            horizon_hours=12.0,
                                            device="cpu"))
    io, tl = ab["reports"]["instance_only"], ab["reports"]["two_level"]
    assert io.preemptions > 0, "baseline must exercise preemption"
    assert tl.preemptions < io.preemptions
    assert tl.elastic_demoted > 0
    assert tl.requeued < io.requeued
    assert ab["goodput_uplift"] > 0
    assert tl.slo_attainment >= io.slo_attainment
    assert tl.elastic_admitted > 0 and tl.elastic_completed > 0


@pytest.mark.parametrize("engine", ["imp", "imp_batched"])
def test_two_level_day_metrics_deterministic(engine):
    a = run_day_cycle(two_level_config(engine=engine))
    b = run_day_cycle(two_level_config(engine=engine))
    assert a.key_metrics() == b.key_metrics()
    assert a.elastic_admitted > 0 and a.elastic_completed > 0


def test_monitored_instance_only_run_schedules_identically():
    """elastic_cfg WITHOUT elastic=True is the monitored baseline: the SLO
    monitor observes but the ladder must not change a single decision."""
    plain = run_day_cycle(ColocationConfig(num_nodes=8, seed=0, engine="imp",
                                           horizon_hours=12.0, device="cpu"))
    monitored = run_day_cycle(ColocationConfig(
        num_nodes=8, seed=0, engine="imp", horizon_hours=12.0,
        elastic_cfg=ElasticConfig(), device="cpu"))
    for metric in ("scheduled_perf", "offline_goodput", "preemptions",
                   "placements", "requeued", "requeue_replanned"):
        assert getattr(monitored, metric) == getattr(plain, metric)
    assert monitored.elastic_admitted == 0


# ---- compare_two_level against the reference and the committed file ----------------

@pytest.mark.parametrize("engine", ["imp", "imp_batched"])
def test_compare_two_level_matches_reference(engine):
    """8 nodes x 12 h: both modes' ``key_metrics()`` and per-class SLO rows,
    and the A/B dict, equal to the reference's host ``imp`` run."""
    kw = dict(num_nodes=8, seed=0, horizon_hours=12.0)
    got = compare_two_level(ColocationConfig(engine=engine, device="cpu",
                                             **kw))
    want = ref_coloc.compare_two_level(ref_coloc.ColocationConfig(
        engine="imp", **kw))
    for mode in ("instance_only", "two_level"):
        g, w = got["reports"][mode], want["reports"][mode]
        assert without_engine(g.key_metrics()) == without_engine(
            w.key_metrics()), mode
        assert g.slo_by_class() == w.slo_by_class()
    for key in ("goodput_uplift", "slo_attainment", "preemptions",
                "preemption_delta", "requeued"):
        assert got[key] == want[key], key


def test_two_level_matches_bench():
    """The committed two-level A/B (``benchmarks/bench_elastic.py``: 24
    nodes x 24 h, seed 0, warm-up on, default `ElasticConfig`): every field
    of both modes of ``BENCH_elastic.json`` and the two A/B numbers, with
    host ``imp`` (~32 s on a CPU, nearly all of it the elastic pool's
    admission scans, as in the reference).  The committed engine
    ``imp_batched`` takes ~50 s here with its plain kernels, so it is held
    to this file at 8 nodes (above) and at 24 nodes by ``chip_smoke.py``
    on the card."""
    bench = json.loads((ROOT / "BENCH_elastic.json").read_text())
    ab = compare_two_level(ColocationConfig(
        num_nodes=bench["num_nodes"], seed=bench["seed"], engine="imp",
        horizon_hours=bench["horizon_hours"], warmup=True,
        elastic_cfg=ElasticConfig(), device="cpu"))
    for mode, want in bench["modes"].items():
        rep = ab["reports"][mode]
        for field, value in want.items():
            got = (rep.slo_by_class() if field == "slo_by_class"
                   else getattr(rep, field))
            assert got == value, (mode, field)
    assert ab["goodput_uplift"] == bench["goodput_uplift"]
    assert ab["preemption_delta"] == bench["preemption_delta"]
