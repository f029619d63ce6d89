"""The port's two-stage shortlist against the reference's.

* The plain prescreen (``kernels.prescreen.prescreen_plain``) against the
  reference's ``_prescreen_core`` called eagerly on the same random
  resident states (patch rows overlaid, forced representatives set, tie
  heavy rows): ``gidx`` equal as a set and in order, ``excl_ub`` equal bit
  for bit, for k from 1 to every row.
* Fingerprints (``SourcingContext.fp``) equal to the reference's bit for
  bit, incremental equal to fresh, and `DeviceClusterState.rep_classes`
  one lowest-index representative a class.
* The reference's ``test_shortlist.py`` cases at a small size, with
  ``shortlist_k`` below the node count so the prescreen prunes: decisions
  of the shortlisted ``imp_batched`` (``device="cpu"``, the plain versions)
  against the port's full-sweep ``imp_batched_full`` and the reference's
  host ``imp`` (never its live ``imp_batched``: ROADMAP.md R1).
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.cluster import apply_rows as ref_apply_rows  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.preemption_jax import _prescreen_core  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.simulator import \
    build_saturated_cluster as ref_build  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.core.workload import WorkloadSpec as RefWorkloadSpec  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (Cluster, ColocationConfig,  # noqa: E402
                              TopoScheduler, WorkloadSpec, instance_rows,
                              run_day_cycle, table3_workloads)
from repro_torch.core.cluster import IDX_SENTINEL  # noqa: E402
from repro_torch.core.cluster import SourcingContext  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.preemption_device import PATH_COUNTS  # noqa: E402
from repro_torch.core.scheduler import ShortlistConfig  # noqa: E402
from repro_torch.core.simulator import decision_key  # noqa: E402
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels.fused_class import FusedRequest  # noqa: E402
from repro_torch.kernels.prescreen import prescreen, prescreen_plain  # noqa: E402

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}
INT32_MAX = 2**31 - 1
CAP = 16


def _carried(ref: RefCluster) -> Cluster:
    return Cluster.from_instances(SPECS[ref.spec.name], ref.num_nodes,
                                  instance_rows(ref), device="cpu")


def _sat_pair(num_nodes: int = 24, seed: int = 0):
    ref = ref_build(RefSimConfig(num_nodes=num_nodes, seed=seed))
    return ref, _carried(ref)


def _keys(sched, wl, **kw):
    return decision_key(sched.plan(wl, **kw).decision)


# ---------------------------------------------------------------------------------
# The prescreen against the reference's _prescreen_core
# ---------------------------------------------------------------------------------

def _random_rows(spec, rows: int, seed: int, tie_heavy: bool):
    """Resident rows as the allocator leaves them (one node's masks
    disjoint), some truncated, some sentinel rows, and with ``tie_heavy``
    runs of identical rows and a few priorities only."""
    rng = np.random.default_rng(seed)
    ns = np.zeros((5, rows), np.int32)
    v = np.zeros((5, rows, CAP), np.int32)
    for r in range(rows):
        if tie_heavy and r and rng.random() < 0.4:
            ns[:, r], v[:, r] = ns[:, r - 1], v[:, r - 1]
            ns[2, r] = r
            continue
        s = int(rng.integers(0, 11))
        own_g = rng.integers(-1, s + 1, spec.num_gpus)
        own_c = rng.integers(-1, s + 1, spec.num_coregroups)
        prio = np.sort(rng.choice([1, 2, 200, 200, 900], s) if tie_heavy
                       else rng.integers(0, 1600, s))
        ranks = rng.permutation(s)
        for j in range(s):
            v[0, r, j] = sum(1 << i for i in np.nonzero(own_g == j + 1)[0])
            v[1, r, j] = sum(1 << i for i in np.nonzero(own_c == j + 1)[0])
            v[2, r, j], v[3, r, j], v[4, r, j] = prio[j], ranks[j], 1
        ns[0, r] = sum(1 << i for i in np.nonzero(own_g == 0)[0])
        ns[1, r] = sum(1 << i for i in np.nonzero(own_c == 0)[0])
        ns[2, r] = IDX_SENTINEL if rng.random() < 0.05 else r
        if rng.random() < 0.1:
            ns[3, r], ns[4, r] = 1, int(rng.integers(0, 1600))
        else:
            ns[4, r] = INT32_MAX
    return ns, v


def _flat(ns, v):
    p = ns.shape[1]
    dr = np.zeros((2, p), np.int32)
    return np.concatenate([ns.T, v.transpose(1, 0, 2).reshape(p, -1), dr.T],
                          axis=1).astype(np.int32)


#: (preemptor priority, need_gpus, need_cgs, cgs_per_bundle): every need
#: size, an unbundled and a zero-need one, two bundle sizes
REQUESTS = ((1000, 1, 1, 1), (300, 2, 2, 1), (1000, 4, 4, 0),
            (1500, 8, 8, 1), (1000, 0, 0, 0), (900, 2, 4, 2))
PRESCREEN_CASES = [
    (sku, seed, tie, k, alpha)
    for sku in sorted(SPECS) for seed, tie in ((0, False), (1, True))
    for k, alpha in ((1, 0.5), (7, 0.0), (40, 1.0), (97, 0.5))]


@pytest.mark.parametrize("sku,seed,tie,k,alpha", PRESCREEN_CASES)
def test_prescreen_plain_matches_reference(sku, seed, tie, k, alpha):
    spec, ref_spec = SPECS[sku], REF_SPECS[sku]
    rows = 97
    ns, v = _random_rows(spec, rows, seed, tie)
    rng = np.random.default_rng(50 + seed)
    rep = rng.random(rows) < 0.7
    pnodes = np.sort(rng.choice(rows, 6, replace=False)).astype(np.int32)
    pns, pv = _random_rows(spec, 6, seed + 7, tie)
    pns[2] = pnodes
    pidx = np.concatenate([pnodes, [IDX_SENTINEL, IDX_SENTINEL]]).astype(
        np.int32)
    pbuf = np.concatenate([_flat(pns, pv), np.zeros((2, _flat(pns, pv)
                                                      .shape[1]), np.int32)])
    forced = np.sort(rng.choice(rows, 5, replace=False)).astype(np.int32)
    dr = np.zeros((2, rows), np.int32)
    for thresh, ng, nc, cpb in REQUESTS:
        wl = (thresh, ng, nc, cpb)
        req = FusedRequest(thresh, ng, nc, cpb, alpha)
        got = prescreen_plain(
            torch.from_numpy(ns), torch.from_numpy(v), torch.from_numpy(pidx),
            torch.from_numpy(pbuf), torch.from_numpy(rep.astype(np.int32)),
            torch.from_numpy(forced), k=k, req=req, spec=spec).numpy()
        # the reference on the same overlaid rows and forced representatives
        ons, ov, odr = ref_apply_rows(jnp.asarray(ns), jnp.asarray(v),
                                      jnp.asarray(dr), jnp.asarray(pidx),
                                      jnp.asarray(pbuf))
        rrep = rep.copy()
        rrep[forced] = True
        gidx, excl = _prescreen_core(ons, ov, odr, jnp.asarray(rrep),
                                     thresh, ng, nc, cpb, alpha,
                                     spec=ref_spec, k=k)
        gidx = np.asarray(gidx)
        assert set(got[:k].tolist()) == set(gidx.tolist()), (wl, k)
        assert got[:k].tolist() == gidx.tolist(), (wl, k)
        want = np.asarray(excl, np.float32).reshape(1).view(np.int32)[0]
        assert got[k] == want, (wl, k, got[k], want)


@pytest.mark.parametrize("nodes,k", [(24, 6), (160, 128)])
def test_shortlist_winner_and_certainty_match_reference(nodes, k):
    """The whole first plan of the shortlist — prescreen, the sweep over
    its rows, the tail — against the reference's ``_shortlist_winner``
    called eagerly on the same saturated state: the same winner, real node
    id and certainty bit (certain where the classes fit in k, uncertain on
    the small shortlists of many classes)."""
    from repro.core.preemption_jax import _shortlist_winner
    from repro_torch.core import preemption_device as pd

    ref, port = _sat_pair(nodes, seed=0)
    rd, dcs = ref.device_state().sync(), port.device_state().sync()
    certain = set()
    for name in ("B", "C", "D"):
        for alpha in (0.0, 1.0):
            req = pd._request(port.spec, WL3[name], alpha)
            want = [int(x) for x in _shortlist_winner(
                rd.nodestate, rd.victims, rd.drain, rd.rep_classes()[1],
                req.thresh, req.need_gpus, req.need_cgs, req.cgs_per_bundle,
                alpha, spec=ref.spec, k=k)]
            _, staged = pd._shortlist_plan_args(dcs, {}, req.thresh)
            got = pd._shortlist_winner(dcs, staged, dcs.rep_classes()[1],
                                       req, port.spec, k).tolist()
            win, sel, cert = pd._shortlist_decode(got, k, alpha)
            assert win == want[:9], (name, alpha)
            assert (sel[win[1]] if win[0] else -1) == want[9], (name, alpha)
            assert int(cert) == want[10], (name, alpha)
            certain.add(cert)
    if k == 128:
        assert certain == {True}


def test_prescreen_wrapper_checks_and_skip():
    """``k`` outside 1..N raises; a set ``skip`` returns at once (sentinels
    on the CPU); the wrapper writes into ``out``."""
    spec = SPECS["rtx4090"]
    ns, v = _random_rows(spec, 10, 3, False)
    args = [torch.from_numpy(x) for x in (ns, v)] + [
        torch.zeros(0, dtype=torch.int32),
        torch.zeros((0, 87), dtype=torch.int32),
        torch.ones(10, dtype=torch.int32), torch.zeros(0, dtype=torch.int32)]
    req = FusedRequest(1000, 1, 2, 2, 0.5)
    for k in (0, 11):
        with pytest.raises(ValueError):
            prescreen(*args, k=k, req=req, spec=spec)
    out = torch.zeros(11, dtype=torch.int32)
    got = prescreen(*args, k=10, req=req, spec=spec, out=out)
    assert got is out and torch.equal(out, prescreen_plain(
        *args, k=10, req=req, spec=spec))
    skipped = prescreen(*args, k=10, req=req, spec=spec,
                        skip=torch.ones(1, dtype=torch.int32))
    assert (skipped[:10] == IDX_SENTINEL).all()


# ---------------------------------------------------------------------------------
# Fingerprints and equivalence classes
# ---------------------------------------------------------------------------------

def test_fingerprints_equal_the_references():
    """The same blake2b-8 over the same fields and bytes: the port's
    fingerprints equal the reference's bit for bit, before and after a
    burst of commits (the vectorised journal replay)."""
    ref, port = _sat_pair(24, seed=3)
    rctx, ctx = ref.sourcing_context(), port.sourcing_context()
    rctx.refresh()
    ctx.refresh()
    assert np.array_equal(ctx.fp, rctx.fp)
    rs = RefScheduler(ref, engine="imp")
    ps = TopoScheduler(port, engine="imp_batched", shortlist_k=6)
    for name in ("B", "C", "B", "C"):
        rt, pt = rs.plan(REF_WL3[name]), ps.plan(WL3[name])
        assert decision_key(rt.decision) == decision_key(pt.decision)
        if pt.decision.kind != "rejected":
            rt.commit()
            pt.commit()
    rctx.refresh()
    ctx.refresh()
    assert np.array_equal(ctx.fp, rctx.fp)


def test_fingerprint_incremental_matches_fresh():
    _, cluster = _sat_pair(24, seed=3)
    ctx = cluster.sourcing_context()
    ctx.refresh()
    sched = TopoScheduler(cluster, engine="imp_batched", shortlist_k=6)
    for name in ("B", "C", "B", "C"):
        txn = sched.plan(WL3[name])
        if txn.decision.kind != "rejected":
            txn.commit()
    ctx.refresh()
    fresh = SourcingContext(cluster)
    fresh.refresh()
    assert np.array_equal(ctx.fp, fresh.fp)
    # rows re-encoded one by one (refresh_row) give the same fingerprints
    for node in range(cluster.num_nodes):
        fresh.refresh_row(node, cluster)
    assert np.array_equal(ctx.fp, fresh.fp)


def test_fingerprint_identical_rows_collide_only_when_identical():
    cluster = Cluster(SPECS["rtx4090"], 8, device="cpu")
    ctx = cluster.sourcing_context()
    ctx.refresh()
    assert len(set(ctx.fp.tolist())) == 1
    cluster.bind(WL3["D"], 3, Placement(1, 1, 0))
    ctx.refresh()
    fps = ctx.fp.tolist()
    assert len(set(fps)) == 2 and fps.count(fps[3]) == 1


def test_rep_classes_one_lowest_index_rep_per_class():
    rng = random.Random(1)
    cluster = Cluster(SPECS["rtx4090"], 10, device="cpu")
    for node in range(10):
        for g in range(8):
            if rng.random() < 0.5:
                cluster.bind(WL3["D"], node, Placement(1 << g, 1 << g, 0))
    dcs = cluster.device_state().sync()
    rep, rep_dev = dcs.rep_classes()
    fp = dcs.mirror.fp
    assert int(rep.sum()) == len(set(fp.tolist()))
    for val in set(fp.tolist()):
        members = np.nonzero(fp == val)[0]
        assert rep[members[0]] and not rep[members[1:]].any()
    assert rep_dev.dtype == torch.int32 and rep_dev.device == dcs.device
    assert rep_dev.tolist() == rep.astype(int).tolist()
    rep2, dev2 = dcs.rep_classes()
    assert rep2 is rep and dev2 is rep_dev
    node = next(nd for nd in range(10) if cluster.free_masks(nd)[0])
    fg, fc = cluster.free_masks(node)
    bit = (fg & fc) & -(fg & fc)
    cluster.bind(WL3["D"], node, Placement(bit, bit, 0))
    dcs.sync()
    assert dcs.rep_classes()[0] is not rep


# ---------------------------------------------------------------------------------
# Guaranteed-mode decisions against the full sweep and host imp
# ---------------------------------------------------------------------------------

def _three(ref, port_fn, k, **kw):
    """Schedulers of the shortlisted port engine, its full-sweep oracle and
    the reference's host imp."""
    return (TopoScheduler(port_fn(), engine="imp_batched", shortlist_k=k,
                          **kw),
            TopoScheduler(port_fn(), engine="imp_batched_full", **kw),
            RefScheduler(ref, engine="imp", **kw))


@pytest.mark.parametrize("seed", [0, 3, 11, 42])
@pytest.mark.parametrize("wl_name", ["A", "B", "C"])
def test_shortlist_single_plan_parity(seed, wl_name):
    ref, port = _sat_pair(seed=seed)
    scheds = _three(ref, lambda: _carried(ref), 6)
    got = [_keys(s, wl, allow_normal=False) for s, wl in zip(
        scheds, (WL3[wl_name], WL3[wl_name], REF_WL3[wl_name]))]
    assert got[0] == got[1] == got[2], (seed, wl_name, got)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_shortlist_parity_across_alpha(alpha):
    for seed in (1, 9):
        ref, _ = _sat_pair(seed=seed)
        scheds = _three(ref, lambda: _carried(ref), 4, alpha=alpha)
        got = [_keys(s, wl, allow_normal=False) for s, wl in zip(
            scheds, (WL3["B"], WL3["B"], REF_WL3["B"]))]
        assert got[0] == got[1] == got[2], (seed, alpha, got)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_shortlist_parity_across_skus(spec_name):
    ref_spec = REF_SPECS[spec_name]
    cg = ref_spec.coregroup_size
    kw = dict(name="v", priority=100, gpus_per_instance=1,
              cores_per_instance=cg, preemptible=True)
    pkw = dict(name="P", priority=1000, gpus_per_instance=2,
               cores_per_instance=2 * cg, preemptible=False)
    rng = random.Random(7)
    ref = RefCluster(ref_spec, 6)
    victim = RefWorkloadSpec(**kw)
    for node in range(6):
        for g in range(ref_spec.num_gpus):
            if rng.random() < 0.2:
                continue
            ref.bind(victim, node, RefPlacement(1 << g, 1 << g, 0))
    scheds = _three(ref, lambda: _carried(ref), 4)
    got = [_keys(s, wl, allow_normal=False) for s, wl in zip(
        scheds, (WorkloadSpec(**pkw), WorkloadSpec(**pkw),
                 RefWorkloadSpec(**pkw)))]
    assert got[0] == got[1] == got[2], (spec_name, got)


def test_shortlist_parity_across_commit_and_rollback_sequences():
    """Commits move fingerprints and representatives; rollbacks restore
    them: the shortlisted engine tracks both and keeps deciding as the
    full sweep and host imp do."""
    ref, _ = _sat_pair(seed=5)
    scheds = _three(ref, lambda: _carried(ref), 6)
    seqs = [[], [], []]
    for step, name in enumerate(("B", "C", "B", "B", "C", "A", "B")):
        for sched, seq, wls in zip(scheds, seqs, (WL3, WL3, REF_WL3)):
            txn = sched.plan(wls[name])
            seq.append(decision_key(txn.decision))
            if txn.decision.kind == "rejected":
                continue
            txn.commit()
            if step % 3 == 2:
                txn.rollback()
    assert seqs[0] == seqs[1] == seqs[2]


def test_shortlist_parity_in_plan_batch_with_commits():
    ref, _ = _sat_pair(seed=2)
    scheds = _three(ref, lambda: _carried(ref), 6)
    seqs = [[], [], []]
    for names in (("B", "C", "B"), ("C", "B"), ("B", "B", "C")):
        for sched, seq, wls in zip(scheds, seqs, (WL3, WL3, REF_WL3)):
            txns = sched.plan_batch([wls[n] for n in names])
            for t in txns:
                t.commit()
            seq.extend(decision_key(t.decision) for t in txns)
    assert seqs[0] == seqs[1] == seqs[2]


def test_shortlist_certain_and_fallback_both_run():
    """On a saturated cluster of identical classes the small shortlist
    cannot always prove its winner: the guaranteed fallback runs, and
    certain plans are served by the shortlist alone."""
    ref, _ = _sat_pair(seed=0)
    for key in PATH_COUNTS:
        PATH_COUNTS[key] = 0
    for k in (2, 6, 16):
        scheds = _three(ref, lambda: _carried(ref), k)
        for wl in ("A", "B", "C"):
            got = [_keys(s, w, allow_normal=False) for s, w in zip(
                scheds, (WL3[wl], WL3[wl], REF_WL3[wl]))]
            assert got[0] == got[1] == got[2]
    assert PATH_COUNTS["shortlist"] == 9
    assert PATH_COUNTS["certain"] + PATH_COUNTS["fallback"] == 9


# ---------------------------------------------------------------------------------
# Modes, knobs, provenance
# ---------------------------------------------------------------------------------

def test_shortlist_best_effort_mode_returns_valid_plans():
    """Best-effort skips the certainty fallback: plans still commit
    cleanly (exactly evaluated feasible candidates)."""
    _, cluster = _sat_pair(seed=0)
    sched = TopoScheduler(cluster, engine="imp_batched", shortlist_k=4,
                          shortlist_mode="best_effort")
    assert sched.shortlist == ShortlistConfig(4, "best_effort")
    committed = 0
    for name in ("B", "C", "B"):
        txn = sched.plan(WL3[name])
        if txn.decision.kind != "rejected":
            dec = txn.commit()
            assert dec.instance is not None
            committed += 1
    assert committed
    dec = sched.plan(WL3["B"]).decision
    assert dec.sourcing_provenance["shortlist_mode"] == "best_effort"


def test_shortlist_disabled_below_k():
    ref, _ = _sat_pair(num_nodes=8, seed=0)
    a = TopoScheduler(_carried(ref), engine="imp_batched", shortlist_k=128)
    b = TopoScheduler(_carried(ref), engine="imp_batched_full")
    before = dict(PATH_COUNTS)
    assert _keys(a, WL3["B"]) == _keys(b, WL3["B"])
    for key in ("shortlist", "shortlist_plan2"):
        assert PATH_COUNTS[key] == before[key]


def test_shortlist_config_validation():
    with pytest.raises(ValueError):
        ShortlistConfig(k=128, mode="bogus")
    with pytest.raises(ValueError):
        ShortlistConfig(k=0)


def test_decision_carries_sourcing_provenance():
    """``imp_batched`` carries the shortlist it runs, the full-sweep oracle
    none, as the reference's engines do."""
    ref, _ = _sat_pair(num_nodes=8, seed=0)
    sched = TopoScheduler(_carried(ref), engine="auto", shortlist_k=64,
                          shortlist_mode="guaranteed")
    prov = sched.plan(WL3["B"]).decision.sourcing_provenance
    assert prov["engine"] == "imp_batched" and prov["auto"] is True
    assert prov["shortlist_k"] == 64
    assert prov["shortlist_mode"] == "guaranteed"
    default = TopoScheduler(_carried(ref), engine="imp_batched")
    assert default.shortlist == ShortlistConfig(128, "guaranteed")
    prov = default.plan(WL3["B"]).decision.sourcing_provenance
    assert (prov["shortlist_k"], prov["shortlist_mode"]) == (128,
                                                             "guaranteed")
    full = TopoScheduler(_carried(ref), engine="imp_batched_full")
    assert full.shortlist is None
    want = RefScheduler(ref, engine="imp_batched").plan(
        REF_WL3["B"]).decision.sourcing_provenance
    assert {k: want[k] for k in ("shortlist_k", "shortlist_mode")} == {
        "shortlist_k": 128, "shortlist_mode": "guaranteed"}


def test_day_cycle_guaranteed_shortlist_matches_full_sweep():
    """A seeded day: the guaranteed shortlist (and the batch sessions of
    its scale-ups) reproduces the full sweep's day field for field."""
    base = dict(num_nodes=12, seed=7, horizon_hours=24.0, warmup=False,
                shortlist_k=6, device="cpu")
    before = dict(PATH_COUNTS)
    sl = run_day_cycle(ColocationConfig(engine="imp_batched", **base))
    assert PATH_COUNTS["shortlist_plan2"] > before["shortlist_plan2"]
    full = run_day_cycle(ColocationConfig(engine="imp_batched_full", **base))
    km_sl, km_full = sl.key_metrics(), full.key_metrics()
    assert (km_sl.pop("engine"), km_full.pop("engine")) == (
        "imp_batched", "imp_batched_full")
    assert km_sl == km_full
    assert sl.preemptions > 0
