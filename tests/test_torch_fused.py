"""The fused ``imp_batched`` engine of the port: its kernels' plain versions
against the JAX package's functions, and its decisions against host IMP.

* The class sweep (``class_sweep_plain``, the plain K1 resident form)
  against ``preemption_jax._fused_class_core`` called with traced request
  scalars, for m in {4, 8, 16}, the narrow gate on and off, alpha in {0,
  0.5, 1}, every Table 3 request plus a zero-need one, on random resident
  states with tie-heavy rows.  Exact integer equality.
* The tail (``fused_argmax_plain``) against ``_fused_argmax_core`` +
  ``placement_jax.winner_place`` on the same class winners: exact.  The f32
  Eq. 1 scores that order it are computed with one rounding per operation
  on both sides; a score difference would show as a different winner.
* The pipelines with patch rows and gathered rows against the reference's
  ``_plan_pipeline`` / ``_gathered_pipeline``.
* The normal cycle (``normal_cycle_plain``, the plain K2 form) against the
  reference's ``normal_cycle_core`` run eagerly (the baked-request jit is
  the R1 miscompile; see ROADMAP.md) and against host ``_plan_normal``.
* Decisions of the port's ``imp_batched`` (``device="cpu"``, every kernel's
  plain version) against the reference's host ``imp`` and
  ``imp_batched_legacy``, never against its live ``imp_batched``: the
  decision key ``(kind, node, victims, tier, hit)`` must be identical, and
  where it is recorded so must be the placement masks and the candidate
  count.
"""
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.placement_jax import \
    normal_cycle_core as ref_normal_cycle  # noqa: E402
from repro.core.placement_jax import winner_place as ref_winner_place  # noqa: E402
from repro.core.preemption_jax import (_fused_argmax_core,  # noqa: E402
                                       _fused_class_core, _gathered_pipeline,
                                       _overlay_ns, _plan_pipeline)
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.simulator import \
    build_saturated_cluster as ref_build  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.core.topology import ServerSpec as RefServerSpec  # noqa: E402
from repro.core.workload import TABLE3_INITIAL_INSTANCES  # noqa: E402
from repro.core.workload import TopoPolicy as RefTopoPolicy  # noqa: E402
from repro.core.workload import WorkloadSpec as RefWorkloadSpec  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (AUTO_ENGINE_THRESHOLD, Cluster,  # noqa: E402
                              ServerSpec, TopoPolicy, TopoScheduler,
                              UnknownEngineError, WorkloadSpec, instance_rows,
                              table3_workloads)
from repro_torch.core.cluster import (IDX_SENTINEL, ClusterView,  # noqa: E402
                                      MAX_DENSE_VICTIMS, VF_CG, VF_GPU,
                                      VF_STORED)
from repro_torch.core.engines import get_engine  # noqa: E402
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.preemption_device import ClassWinners  # noqa: E402
from repro_torch.core.simulator import (SimConfig, decision_key,  # noqa: E402
                                        run_hit_rate_experiment)
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels.fused_class import (FusedRequest,  # noqa: E402
                                             class_sweep_plain, fused_argmax,
                                             fused_argmax_plain, fused_class)
from repro_torch.kernels.normal_cycle import normal_cycle_plain  # noqa: E402

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}
INT32_MAX = 2**31 - 1

BIG_CG = dict(name="bigcg", num_sockets=2, num_numa=8, num_cores=192,
              num_gpus=8, coregroup_size=8)   # 24 CoreGroups: 16 victims fit
PORT_BIG, REF_BIG = ServerSpec(**BIG_CG), RefServerSpec(**BIG_CG)


# ---------------------------------------------------------------------------------
# Random resident states (numpy; both packages read the same arrays)
# ---------------------------------------------------------------------------------

def random_state(spec, rows: int, max_victims: int, seed: int,
                 tie_heavy: bool = False, cap: int = MAX_DENSE_VICTIMS):
    """Resident rows as the allocator leaves them: per row, every GPU and
    CoreGroup is free, held by one stored victim, or held by a
    non-preemptible instance — so one node's masks are pairwise disjoint.
    Victims are sorted by priority; ranks are a permutation.  Some rows are
    sentinels, some truncated (overflow with a next priority)."""
    rng = np.random.default_rng(seed)
    ns = np.zeros((5, rows), np.int32)
    v = np.zeros((5, rows, cap), np.int32)
    dr = np.zeros((2, rows), np.int32)
    for r in range(rows):
        s = int(rng.integers(0, max_victims + 1))
        own_g = rng.integers(-1, s + 1, spec.num_gpus)     # -1 held, 0 free
        own_c = rng.integers(-1, s + 1, spec.num_coregroups)
        if tie_heavy:
            prio = np.sort(rng.choice([1, 2, 3, 200, 200, 200], s))
        else:
            prio = np.sort(rng.integers(0, 1600, s))
        ranks = rng.permutation(s)
        for j in range(s):
            v[0, r, j] = sum(1 << i for i in np.nonzero(own_g == j + 1)[0])
            v[1, r, j] = sum(1 << i for i in np.nonzero(own_c == j + 1)[0])
            v[2, r, j] = prio[j]
            v[3, r, j] = ranks[j]
            v[4, r, j] = 1
        ns[0, r] = sum(1 << i for i in np.nonzero(own_g == 0)[0])
        ns[1, r] = sum(1 << i for i in np.nonzero(own_c == 0)[0])
        ns[2, r] = IDX_SENTINEL if rng.random() < 0.08 else r
        if rng.random() < 0.15:
            ns[3, r] = 1
            ns[4, r] = int(rng.integers(0, 1600))
        else:
            ns[4, r] = INT32_MAX
        dr[0, r] = ns[0, r] | np.bitwise_or.reduce(v[0, r])
        dr[1, r] = ns[1, r] | np.bitwise_or.reduce(v[1, r])
    return ns, v, dr


def requests(spec):
    """(thresh, ng, nc, cpb) of every Table 3 preemptor plus a zero-need
    ask."""
    out = []
    for wl in ref_table3():
        if wl.cores_per_instance % spec.coregroup_size:
            continue            # the ask does not fit this SKU's CoreGroups
        ng = wl.gpus_per_instance
        nc = wl.coregroups_per_instance(spec.coregroup_size)
        bundle = wl.numa_policy == RefTopoPolicy.GUARANTEED
        out.append((wl.priority, ng, nc, nc // ng if (bundle and ng) else 0))
    out.append((1000, 0, 0, 0))
    return out


@functools.lru_cache(maxsize=None)
def ref_class_core(spec, m: int, gate: bool):
    """The reference's class sweep jitted with the request as traced
    scalars (not the baked-request evaluators)."""
    return jax.jit(functools.partial(_fused_class_core, spec=spec, m=m,
                                     narrow_gate=gate))


def _t(x):
    return torch.from_numpy(np.asarray(x))


SWEEP_CASES = {4: (RTX := "rtx4090", 24, 8), 8: (RTX, 24, 10),
               16: ("bigcg", 3, 16)}


def _spec_pair(name):
    if name == "bigcg":
        return PORT_BIG, REF_BIG
    return SPECS[name], REF_SPECS[name]


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("gate", [True, False], ids=["gate", "nogate"])
@pytest.mark.parametrize("m", [4, 8, 16])
def test_class_sweep_and_tail_match_reference(m, gate, alpha):
    spec_name, rows, max_victims = SWEEP_CASES[m]
    spec, ref_spec = _spec_pair(spec_name)
    for tie_heavy in (False, True):
        ns, v, dr = random_state(spec, rows, max_victims,
                                 seed=100 * m + 10 * gate + int(2 * alpha)
                                 + tie_heavy, tie_heavy=tie_heavy)
        for thresh, ng, nc, cpb in requests(spec):
            if tie_heavy:
                thresh = 300            # the 1/2/3 priorities are eligible
            req = FusedRequest(thresh, ng, nc, cpb, alpha)
            ref = ref_class_core(ref_spec, m, gate)(
                jnp.asarray(ns), jnp.asarray(v), jnp.asarray(dr),
                jnp.int32(thresh), jnp.int32(ng), jnp.int32(nc),
                jnp.int32(cpb), jnp.float32(alpha))
            got = class_sweep_plain(_t(ns), _t(v), _t(dr), m=m, gate=gate,
                                    req=req, spec=spec)
            what = (m, gate, alpha, tie_heavy, thresh, ng, nc, cpb)
            for name, x in ClassWinners.of(got)._asdict().items():
                assert np.array_equal(x.numpy(),
                                      np.asarray(getattr(ref, name))), \
                    (name, what)
            assert np.array_equal(got[14].numpy(), ns[2]), what
            # the tail: Eq. 2 argmax + the winner's placement (alpha as the
            # Python float the reference bakes)
            win = _fused_argmax_core(jnp.asarray(ns[2]), ref, alpha)
            want = ref_winner_place(win, jnp.asarray(ns[0]),
                                    jnp.asarray(ns[1]), jnp.asarray(v[0]),
                                    jnp.asarray(v[1]), ng, nc, cpb,
                                    spec=ref_spec)
            empty = torch.zeros(0, dtype=torch.int32)
            tail = fused_argmax_plain(
                got, _t(ns), _t(v), empty, torch.zeros((0, 87), dtype=torch.int32),
                empty, resident=True, seg=rows, req=req, spec=spec)
            assert tail.tolist() == [np.asarray(want).tolist()], what


def test_tail_breaks_an_exact_cross_tier_tie_by_victim_count():
    """Two rows whose class winners score exactly 0.75 at alpha 0.5: (tier
    0, priority sum 2, k 1) and (tier 1, priority sum 1, k 2).  Survivors in
    different tiers skip the priority-sum refinement, so fewer victims
    wins: row 0, as in the reference's tail."""
    spec, ref_spec = _spec_pair("rtx4090")
    ns = np.array([[0, 0], [0, 0], [0, 1], [0, 0], [INT32_MAX] * 2],
                  np.int32)
    v = np.zeros((5, 2, 16), np.int32)
    v[:, 0, 0] = (1, 1, 2, 0, 1)           # one victim, priority 2
    v[:, 1, 0] = (1, 0, 0, 0, 1)           # GPU 0 only, priority 0
    v[:, 1, 1] = (0, 2, 1, 1, 1)           # CoreGroup 1 only, priority 1
    dr = np.array([[1, 1], [1, 2]], np.int32)
    req = FusedRequest(1000, 1, 1, 0, 0.5)
    ref = ref_class_core(ref_spec, 4, True)(
        jnp.asarray(ns), jnp.asarray(v), jnp.asarray(dr), jnp.int32(1000),
        jnp.int32(1), jnp.int32(1), jnp.int32(0), jnp.float32(0.5))
    got = class_sweep_plain(_t(ns), _t(v), _t(dr), m=4, gate=True, req=req,
                            spec=spec)
    assert got[0:3].T.tolist() == np.asarray(ref.anyc).tolist() == [
        [1, 0, 0], [0, 1, 0]]
    assert got[6:9].T.tolist() == np.asarray(ref.pp).tolist()
    win = _fused_argmax_core(jnp.asarray(ns[2]), ref, 0.5)
    want = ref_winner_place(win, jnp.asarray(ns[0]), jnp.asarray(ns[1]),
                            jnp.asarray(v[0]), jnp.asarray(v[1]), 1, 1, 0,
                            spec=ref_spec)
    empty = torch.zeros(0, dtype=torch.int32)
    tail = fused_argmax_plain(got, _t(ns), _t(v), empty,
                              torch.zeros((0, 87), dtype=torch.int32), empty,
                              resident=True, seg=2, req=req, spec=spec)
    assert tail.tolist() == [np.asarray(want).tolist()]
    assert tail[0, :6].tolist() == [1, 0, 0, 1, 2, 1]


@pytest.mark.parametrize("pipeline,m", [("plan", 4), ("plan", 8),
                                        ("gathered", 16)])
def test_pipelines_with_patch_and_gathered_rows_match_reference(pipeline, m):
    """Patch rows read in place of resident rows (pidx ascending, sentinel
    pads) and rows gathered by index (sentinel pads gather zero rows),
    through the sweep and its tail, against the reference's pipelines."""
    spec_name = "bigcg" if m == 16 else "rtx4090"
    spec, ref_spec = _spec_pair(spec_name)
    n = 12
    ns, v, dr = random_state(spec, n, 8 if m < 16 else 16, seed=7 + m)
    ns[2] = np.arange(n)                         # resident ids = row ids
    pns, pv, pdr = random_state(spec, 3, 8, seed=70 + m)
    pidx = np.array([2, 5, 9, IDX_SENTINEL], np.int32)
    pns[2] = pidx[:3]
    pbuf = np.zeros((4, 87), np.int32)
    pbuf[:3] = np.concatenate([pns.T, pv.transpose(1, 0, 2).reshape(3, -1),
                               pdr.T], axis=1)
    gidx = np.array([5, 1, 11, IDX_SENTINEL], np.int32)
    for alpha in (0.5,):
        for thresh, ng, nc, cpb in requests(spec)[1:]:
            req = FusedRequest(thresh, ng, nc, cpb, alpha)
            if pipeline == "plan":
                fn = jax.jit(functools.partial(
                    _plan_pipeline, spec=ref_spec, m=m, p=4, g=4,
                    alpha=alpha))
                want = fn(jnp.asarray(ns), jnp.asarray(v), jnp.asarray(dr),
                          jnp.asarray(np.concatenate([pidx, gidx])),
                          jnp.asarray(pbuf), thresh=jnp.int32(thresh),
                          ng=jnp.int32(ng), nc=jnp.int32(nc),
                          cpb=jnp.int32(cpb))
                resident, m_res, seg = True, m, n + 4
            else:
                fn = jax.jit(functools.partial(
                    _gathered_pipeline, spec=ref_spec, m=m, p=4,
                    alpha=alpha))
                want = fn(jnp.asarray(ns), jnp.asarray(v), jnp.asarray(dr),
                          jnp.asarray(pidx), jnp.asarray(pbuf),
                          jnp.asarray(gidx), thresh=jnp.int32(thresh),
                          ng=jnp.int32(ng), nc=jnp.int32(nc),
                          cpb=jnp.int32(cpb))
                resident, m_res, seg = False, m, 4
            args = (_t(ns), _t(v), _t(dr), _t(pidx), _t(pbuf), _t(gidx))
            cls = fused_class(*args, m_res=m_res, resident=resident,
                              m_gather=8 if pipeline == "plan" else m,
                              req=req, spec=spec)
            got = fused_argmax(cls, *args[:2], *args[3:], resident=resident,
                               seg=seg, req=req, spec=spec)
            assert got.tolist() == [np.asarray(want).tolist()], (
                pipeline, m, alpha, thresh, ng, nc, cpb)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_normal_cycle_matches_reference_eager(spec_name):
    """The plain K2 form against the reference's ``normal_cycle_core`` run
    eagerly, with and without patch rows, on random free masks (some rows
    sentinels, some states with no feasible node)."""
    spec, ref_spec = SPECS[spec_name], REF_SPECS[spec_name]
    rng = np.random.default_rng(5)
    for trial in range(3):
        n = 9
        ns = np.zeros((5, n), np.int32)
        dens = (0.2, 0.6, 0.0)[trial]
        for r in range(n):
            ns[0, r] = sum(1 << i for i in range(spec.num_gpus)
                           if rng.random() < dens)
            ns[1, r] = sum(1 << i for i in range(spec.num_coregroups)
                           if rng.random() < dens)
            ns[2, r] = IDX_SENTINEL if rng.random() < 0.1 else r
            ns[4, r] = INT32_MAX
        v = np.zeros((5, n, 16), np.int32)
        dr = np.zeros((2, n), np.int32)
        pidx = np.array([1, 4, IDX_SENTINEL, IDX_SENTINEL], np.int32)
        pbuf = np.zeros((4, 87), np.int32)
        pbuf[:2, 0] = spec.all_gpu_mask
        pbuf[:2, 1] = [spec.all_cg_mask, 0]
        pbuf[:2, 2] = [1, 4]
        for thresh, ng, nc, cpb in requests(spec):
            req = FusedRequest(thresh, ng, nc, cpb, 0.5)
            want = ref_normal_cycle(jnp.asarray(ns), ng, nc, cpb,
                                    spec=ref_spec)
            got = normal_cycle_plain(_t(ns), _t(v), _t(dr),
                                     torch.zeros(0, dtype=torch.int32),
                                     torch.zeros((0, 87), dtype=torch.int32), req,
                                     spec)
            assert got.tolist() == np.asarray(want).tolist(), (trial, ng, nc)
            want = ref_normal_cycle(
                _overlay_ns(jnp.asarray(ns), jnp.asarray(pidx),
                            jnp.asarray(pbuf)), ng, nc, cpb, spec=ref_spec)
            got = normal_cycle_plain(_t(ns), _t(v), _t(dr), _t(pidx),
                                     _t(pbuf), req, spec)
            assert got.tolist() == np.asarray(want).tolist(), (trial, ng, nc)


# ---------------------------------------------------------------------------------
# Decisions of the engine
# ---------------------------------------------------------------------------------

def ref_random_cluster(seed: int, nodes: int = 5) -> RefCluster:
    rng = random.Random(seed)
    cluster = RefCluster(REF_SPECS["rtx4090"], nodes)
    for node in range(nodes):
        free = list(range(8))
        rng.shuffle(free)
        while free:
            if len(free) >= 2 and rng.random() < 0.4:
                g = [free.pop(), free.pop()]
                wl = REF_WL3["C"]
            else:
                g = [free.pop()]
                wl = REF_WL3["D"]
            if rng.random() < 0.2:
                continue  # leave a hole
            mask = sum(1 << x for x in g)
            cluster.bind(wl, node, RefPlacement(mask, mask, 0))
    return cluster


def carried(ref: RefCluster, spec=None) -> Cluster:
    """The port's copy of a reference cluster (uids kept)."""
    spec = spec or SPECS[ref.spec.name]
    return Cluster.from_instances(spec, ref.num_nodes, instance_rows(ref),
                                  device="cpu")


def _full_key(dec):
    return decision_key(dec) + (
        None if dec.placement is None else
        (dec.placement.gpu_mask, dec.placement.cg_mask),)


def _ref_protocol_keys(num_nodes, seed, cycles, scaleups):
    keys = []
    for cycle in range(cycles):
        cluster = ref_build(RefSimConfig(num_nodes=num_nodes,
                                         seed=seed + cycle))
        sched = RefScheduler(cluster, engine="imp", alpha=0.5)
        rng = random.Random(10_000 + seed + cycle)
        for _ in range(scaleups):
            dec = sched.plan(REF_WL3[rng.choice(("B", "C"))]).decision
            keys.append(decision_key(dec))
    return keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hit_rate_protocol_matches_host_imp(seed):
    """Table 4's protocol through ``TopoScheduler.plan()`` with the fused
    engine: decision for decision the reference's host ``imp``."""
    report = run_hit_rate_experiment(
        SimConfig(num_nodes=20, seed=seed, device="cpu"), "imp_batched",
        cycles=2, scaleups_per_cycle=10)
    assert report.decision_keys == _ref_protocol_keys(20, seed, 2, 10)
    assert report.preemptions + report.placements + report.failures == 20


def _partial_pair(seed: int, nodes: int, fill: float = 0.6):
    counts = {k: max(0, round(v * nodes / 100.0 * fill))
              for k, v in TABLE3_INITIAL_INSTANCES.items()}
    ref = ref_build(RefSimConfig(num_nodes=nodes, seed=seed), counts=counts)
    return ref, carried(ref)


@pytest.mark.parametrize("seed", [0, 3, 11, 42])
def test_normal_cycle_decisions_match_host(seed):
    """Clusters with free room: plan() resolves in the normal cycle with the
    same node, masks, tier and hit as the host loop of both packages."""
    for name in ("A", "B", "C", "D"):
        ref, port = _partial_pair(seed, 6)
        want = _full_key(RefScheduler(ref, engine="imp")
                         .plan(REF_WL3[name]).decision)
        got = _full_key(TopoScheduler(port, engine="imp_batched")
                        .plan(WL3[name]).decision)
        host = _full_key(TopoScheduler(carried(ref), engine="imp")
                         .plan(WL3[name]).decision)
        assert got == want == host, (seed, name)
        if name in ("C", "D"):
            assert got[0] == "placed"
        # the normal cycle alone (schedule) through the same launch, and
        # through the registry's normal-cycle hook
        got = _full_key(TopoScheduler(port, engine="imp_batched").plan(
            WL3[name], allow_preempt=False).decision)
        want = _full_key(RefScheduler(ref, engine="imp").plan(
            REF_WL3[name], allow_preempt=False).decision)
        assert got == want, (seed, name)
        normal = get_engine("imp_batched").plan_normal(port, WL3[name])
        assert (None if normal is None else
                (normal[0], normal[1].tier, normal[1].gpu_mask,
                 normal[1].cg_mask)) == (
            None if want[0] == "rejected" else
            (want[1], want[3], want[5][0], want[5][1])), (seed, name)


@pytest.mark.parametrize("seed", [2, 9])
def test_schedule_or_preempt_rollback_sequence_matches_host(seed):
    """Commit / rollback sequences: the resident state tracks every
    mutation and the chained plan keeps agreeing with host ``imp``
    (the sequence of the reference's R1-red parity test, held here to
    its host engine)."""
    seqs = {}
    for who in ("ref", "port"):
        ref, port = _partial_pair(seed, 5)
        sched = (RefScheduler(ref, engine="imp") if who == "ref"
                 else TopoScheduler(port, engine="imp_batched"))
        wls = REF_WL3 if who == "ref" else WL3
        seq, pending = [], []
        for step, name in enumerate(("C", "B", "D", "C", "B", "D", "C")):
            txn = sched.plan(wls[name])
            txn.commit()
            pending.append(txn)
            seq.append(_full_key(txn.decision))
            if step % 3 == 2:
                pending.pop().rollback()
                pending.pop().rollback()
        seqs[who] = seq
    assert seqs["ref"] == seqs["port"]


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 42, 1234])
@pytest.mark.parametrize("wl_name", ["A", "B", "C"])
def test_fused_matches_host_imp_on_random_clusters(seed, wl_name):
    ref = ref_random_cluster(seed)
    want = _full_key(RefScheduler(ref, engine="imp").plan(
        REF_WL3[wl_name], allow_normal=False).decision)
    got = _full_key(TopoScheduler(carried(ref), engine="imp_batched").plan(
        WL3[wl_name], allow_normal=False).decision)
    assert got == want


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_fused_parity_across_alpha(alpha):
    """Eq. 1's weighting happens on the device: sweep alpha across the
    tie-break branches, against host imp and the reference's legacy
    batched engine."""
    for seed in (1, 9, 77):
        keys = set()
        for engine in ("imp", "imp_batched_legacy"):
            keys.add(decision_key(RefScheduler(
                ref_random_cluster(seed), engine=engine, alpha=alpha).plan(
                REF_WL3["B"], allow_normal=False).decision))
        keys.add(decision_key(TopoScheduler(
            carried(ref_random_cluster(seed)), engine="imp_batched",
            alpha=alpha).plan(WL3["B"], allow_normal=False).decision))
        assert len(keys) == 1, (seed, alpha, keys)


@pytest.mark.parametrize("seed", [0, 7])
def test_num_candidates_matches_legacy(seed):
    """The device counts every feasible min-k subset; the decision reports
    that count, as the reference's legacy batched engine does."""
    want = RefScheduler(ref_random_cluster(seed),
                        engine="imp_batched_legacy").plan(
        REF_WL3["B"], allow_normal=False).decision
    got = TopoScheduler(carried(ref_random_cluster(seed)),
                        engine="imp_batched").plan(
        WL3["B"], allow_normal=False).decision
    assert got.num_candidates == want.num_candidates > 0
    assert decision_key(got) == decision_key(want)


def test_fused_filter_rejects_identically_to_host_filter():
    """Nothing is preemptible below the preemptor: rejected, as the host
    filter loop rejects."""
    blocker = WorkloadSpec("hi", priority=9000, gpus_per_instance=2,
                           cores_per_instance=16, preemptible=False)
    cluster = Cluster(SPECS["rtx4090"], 2, device="cpu")
    for node in range(2):
        for i in range(4):
            mask = 0b11 << (2 * i)
            cluster.bind(blocker, node, Placement(mask, mask, 0))
    for engine in ("imp", "imp_batched"):
        dec = TopoScheduler(cluster, engine=engine).plan(
            WL3["B"], allow_normal=False).decision
        assert dec.rejected, engine
    dec = TopoScheduler(cluster, engine="imp_batched").plan(WL3["B"]).decision
    assert dec.rejected


CPU_JOB = dict(name="cpu-only", priority=200, gpus_per_instance=0,
               cores_per_instance=8, preemptible=True, critical=False,
               kind="offline")


def _big_pair(build):
    ref = build(RefCluster, RefPlacement, REF_BIG, REF_WL3, RefWorkloadSpec,
                RefTopoPolicy)
    return ref, carried(ref, PORT_BIG)


def _wide(cls, placement, spec, wls, wl_cls, policy):
    """Node 0 holds 10 victims (a wide, 16-slot row, not an overflow);
    node 1 is a narrow node."""
    cpu_job = wl_cls(numa_policy=policy.NONE, socket_policy=policy.NONE,
                     **CPU_JOB)
    cluster = cls(spec, 2)
    for i in range(4):
        mask = 0b11 << (2 * i)
        cluster.bind(wls["C"], 0, placement(mask, mask, 0))
    for i in range(6):
        cluster.bind(cpu_job, 0, placement(0, 1 << (8 + i), 0))
    for i in range(6):
        cluster.bind(wls["D"], 1, placement(1 << i, 1 << i, 0))
    return cluster


def _overflow(cls, placement, spec, wls, wl_cls, policy):
    """One node with 18 preemptible victims (> MAX_DENSE_VICTIMS)."""
    cpu_job = wl_cls(numa_policy=policy.NONE, socket_policy=policy.NONE,
                     **CPU_JOB)
    cluster = cls(spec, 1)
    for i in range(4):
        mask = 0b11 << (2 * i)
        cluster.bind(wls["C"], 0, placement(mask, mask, 0))
    for i in range(14):
        cluster.bind(cpu_job, 0, placement(0, 1 << (8 + i), 0))
    return cluster


def _truncated(cls, placement, spec, wls, wl_cls, policy):
    """17 preemptible instances, but only 2 below priority 300: a truncated
    row whose eligible victims fit the stored prefix."""
    cpu500 = wl_cls("cpu500", priority=500, gpus_per_instance=0,
                    cores_per_instance=8, preemptible=True,
                    numa_policy=policy.NONE, socket_policy=policy.NONE,
                    critical=False)
    blocker = wl_cls("blk", priority=5000, gpus_per_instance=6,
                     cores_per_instance=48, preemptible=False)
    cluster = cls(spec, 1)
    for i in range(2):
        cluster.bind(wls["D"], 0, placement(1 << i, 1 << i, 0))
    cluster.bind(blocker, 0, placement(0xFC, 0xFC, 0))
    for i in range(16):
        cluster.bind(cpu500, 0, placement(0, 1 << (8 + i), 0))
    return cluster


@pytest.mark.parametrize("case", ["wide", "overflow", "truncated"])
def test_wide_overflow_and_truncated_rows_match_host(case):
    """Wide rows go to a 16-slot chunk, truncated rows whose eligible
    victims fit stay on the resident sweep, and rows whose eligible victims
    pass the stored prefix fall back to host ``flextopo_imp``."""
    from repro_torch.core.preemption_device import split_fused_nodes

    build = {"wide": _wide, "overflow": _overflow,
             "truncated": _truncated}[case]
    preemptor, ref_preemptor = WL3["B"], REF_WL3["B"]
    if case == "truncated":
        preemptor = WorkloadSpec("mid", priority=300, gpus_per_instance=1,
                                 cores_per_instance=8, preemptible=False)
        ref_preemptor = RefWorkloadSpec("mid", priority=300,
                                        gpus_per_instance=1,
                                        cores_per_instance=8,
                                        preemptible=False)
    ref, port = _big_pair(build)
    split = split_fused_nodes(port.device_state().sync(), {},
                              preemptor.priority)
    expect = {"wide": (split.wide == [0] and split.overflow == []),
              "overflow": split.overflow == [0],
              "truncated": split.wide == [] and split.overflow == []}
    assert expect[case], split
    want = _full_key(RefScheduler(ref, engine="imp").plan(
        ref_preemptor, allow_normal=False).decision)
    got = _full_key(TopoScheduler(port, engine="imp_batched").plan(
        preemptor, allow_normal=False).decision)
    assert got == want and got[0] == "preempted"
    got = _full_key(TopoScheduler(port, engine="imp_batched").plan(
        preemptor).decision)
    want = _full_key(RefScheduler(ref, engine="imp").plan(
        ref_preemptor).decision)
    assert got == want


def test_cross_tier_exact_score_tie_breaks_by_victim_count():
    """(tier 0, prio_sum 2, k=1) and (tier 1, prio_sum 1, k=2) both score
    exactly 0.75 at alpha=0.5; select_best breaks the tie by fewer victims
    and so must the fused chain (port of the reference's case)."""
    def build(cls, placement, spec, wl_cls, policy):
        blocker = wl_cls("blk", priority=5000, gpus_per_instance=7,
                         cores_per_instance=56, preemptible=False)
        v_lo = wl_cls("v2", priority=2, gpus_per_instance=1,
                      cores_per_instance=8, preemptible=True)
        v_a = wl_cls("v0", priority=0, gpus_per_instance=1,
                     cores_per_instance=0, preemptible=True)
        v_b = wl_cls("v1", priority=1, gpus_per_instance=0,
                     cores_per_instance=8, preemptible=True)
        preemptor = wl_cls("P", priority=1000, gpus_per_instance=1,
                           cores_per_instance=8, preemptible=False,
                           numa_policy=policy.BEST_EFFORT)
        cluster = cls(spec, 2)
        cluster.bind(v_lo, 0, placement(1 << 0, 1 << 0, 0))
        cluster.bind(blocker, 0, placement(0xFE, 0xFE, 0))
        cluster.bind(v_a, 1, placement(1 << 0, 0, 0))
        cluster.bind(v_b, 1, placement(0, 1 << 1, 0))
        cluster.bind(blocker, 1, placement(0xFE, 0xFD, 0))
        return cluster, preemptor

    ref, ref_p = build(RefCluster, RefPlacement, REF_SPECS["rtx4090"],
                       RefWorkloadSpec, RefTopoPolicy)
    want = {decision_key(RefScheduler(build(
        RefCluster, RefPlacement, REF_SPECS["rtx4090"], RefWorkloadSpec,
        RefTopoPolicy)[0], engine=e, alpha=0.5).plan(
        ref_p, allow_normal=False).decision)
        for e in ("imp", "imp_batched_legacy")}
    port, p = build(lambda s, n: Cluster(s, n, device="cpu"), Placement,
                    SPECS["rtx4090"], WorkloadSpec, TopoPolicy)
    got = decision_key(TopoScheduler(port, engine="imp_batched",
                                     alpha=0.5).plan(
        p, allow_normal=False).decision)
    assert want == {got}
    assert got[1] == 0 and len(got[2]) == 1    # fewer victims -> node 0


def test_plan_batch_plans_sequentially_against_one_view():
    """``plan_batch`` with the fused engine: each plan sees the earlier
    planned evictions and binds (patch rows), as single plans on one shared
    view do, and as the reference's host imp decides."""
    names = ["B", "C", "B", "B", "C", "D"]
    ref = ref_random_cluster(29)
    want = [decision_key(t.decision) for t in RefScheduler(
        ref, engine="imp").plan_batch([REF_WL3[n] for n in names])]
    batched = TopoScheduler(carried(ref), engine="imp_batched").plan_batch(
        [WL3[n] for n in names])
    port = carried(ref)
    sched = TopoScheduler(port, engine="imp_batched")
    view = ClusterView(port)
    singles = [sched.plan(WL3[n], view=view) for n in names]
    assert [decision_key(t.decision) for t in batched] == want
    assert ([decision_key(t.decision) for t in singles] == want)
    assert ([t.decision.num_candidates for t in batched]
            == [t.decision.num_candidates for t in singles])


def test_explicit_node_list_matches_the_whole_cluster_sweep():
    """``source_all`` with an explicit node list gathers those rows (narrow,
    mid and wide dispatches) and reaches the same winner as ``nodes=None``;
    ``source(node)`` returns that node's best candidate."""
    from repro_torch.core.scoring import select_best

    engine = get_engine("imp_batched")
    port = carried(ref_random_cluster(3, nodes=6))
    everything = engine.source_all(port, WL3["B"], None, alpha=0.5)
    listed = engine.source_all(port, WL3["B"], list(range(6)), alpha=0.5)
    best = select_best(everything, 0.5)
    assert select_best(listed, 0.5) == best
    assert listed.n_candidates == everything.n_candidates
    assert engine.source(port, WL3["B"], best.node)[0] == best


def test_victim_masks_are_disjoint_in_the_resident_state():
    """The sweep folds a subset's freed masks as free | OR of its slots; the
    reference sums them.  The two agree because the allocator keeps one
    node's free mask and victim masks pairwise disjoint: checked here on
    the resident state of saturated and committed-to clusters."""
    ref = ref_build(RefSimConfig(num_nodes=40, seed=3))
    port = carried(ref)
    sched = TopoScheduler(port, engine="imp_batched")
    for name in ("B", "C", "B", "D"):
        sched.schedule_or_preempt(WL3[name])
    dcs = port.device_state().sync()
    for field in (VF_GPU, VF_CG):
        v = dcs.victims[field] * (dcs.victims[VF_STORED] != 0)
        free = dcs.nodestate[field]
        total = free.to(torch.int64) + v.to(torch.int64).sum(dim=1)
        orred = free.clone()
        for j in range(v.shape[1]):
            orred |= v[:, j]
        assert torch.equal(total, orred.to(torch.int64)), field


def test_auto_engine_routes_by_cluster_size(monkeypatch):
    from repro_torch.core import scheduler

    port = carried(ref_random_cluster(1, nodes=3))
    sched = TopoScheduler(port, engine="auto")
    assert sched.engine == "imp_batched"
    dec = sched.plan(WL3["B"]).decision
    assert dec.sourcing_provenance == {
        "engine": "imp_batched", "auto": True,
        "auto_threshold": AUTO_ENGINE_THRESHOLD,
        "shortlist_k": 0, "shortlist_mode": None}
    assert AUTO_ENGINE_THRESHOLD == 4096
    monkeypatch.setattr(scheduler, "AUTO_ENGINE_THRESHOLD", 3)
    with pytest.raises(UnknownEngineError, match="imp_sharded"):
        TopoScheduler(port, engine="auto")
