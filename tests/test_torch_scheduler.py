"""The slice as a whole: ``TopoScheduler.plan()`` of the port, with the host
engines and with ``imp_pallas`` (the plain K1 on CPU tensors), decision for
decision against the JAX package's host engines.

Every port object is built with ``device="cpu"``.  The reference's own
``imp_pallas`` is not run here (its interpreter takes seconds a plan); its
kernels are held against the port's in ``test_torch_topo_score.py``.
"""
import ast
import dataclasses
import pathlib
import random

import pytest

torch = pytest.importorskip("torch")

from repro.core.cluster import Cluster as RefCluster  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.scheduler import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.simulator import \
    build_saturated_cluster as ref_build  # noqa: E402
from repro.core.topology import ServerSpec as RefServerSpec  # noqa: E402
from repro.core.workload import TopoPolicy as RefTopoPolicy  # noqa: E402
from repro.core.workload import WorkloadSpec as RefWorkloadSpec  # noqa: E402
from repro.core.workload import \
    table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (Cluster, Placement, ServerSpec,  # noqa: E402
                              TopoPolicy, TopoScheduler, UnknownEngineError,
                              WorkloadSpec, instance_rows, table3_workloads)
from repro_torch.core.cluster import MAX_DENSE_VICTIMS  # noqa: E402
from repro_torch.core.simulator import (SimConfig,  # noqa: E402
                                        decision_key,
                                        run_hit_rate_experiment)
from repro_torch.core.topology import RTX4090_SERVER  # noqa: E402
from repro_torch.kernels import topo_score as ts  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_protocol_keys(engine, num_nodes=20, seed=0, cycles=3, scaleups=10):
    """The reference's Table 4 protocol (``run_hit_rate_experiment``), one
    decision key per scale-up."""
    workloads = {w.name: w for w in ref_table3()}
    keys = []
    for cycle in range(cycles):
        cluster = ref_build(RefSimConfig(num_nodes=num_nodes,
                                         seed=seed + cycle))
        sched = RefScheduler(cluster, engine=engine, alpha=0.5)
        rng = random.Random(10_000 + seed + cycle)
        for _ in range(scaleups):
            dec = sched.plan(workloads[rng.choice(("B", "C"))]).decision
            keys.append(decision_key(dec))
    return keys


@pytest.mark.parametrize("engine,ref_engine,expect", [
    ("imp", "imp", (30, 30, 0, 0)),
    ("imp_pallas", "imp", (30, 30, 0, 0)),
    ("godel", "godel", (30, 14, 0, 0)),
])
def test_hit_rate_protocol_decisions_match_reference(engine, ref_engine,
                                                     expect):
    report = run_hit_rate_experiment(
        SimConfig(num_nodes=20, seed=0, device="cpu"), engine, cycles=3,
        scaleups_per_cycle=10)
    assert report.decision_keys == _ref_protocol_keys(ref_engine)
    assert (report.preemptions, report.hits, report.failures,
            report.placements) == expect
    assert report.compiled_samples == 0


def test_imp_pallas_sources_every_filtered_node_once():
    """One ``imp_pallas`` call per filtered node per plan, none of them an
    overflow on the Table 3 mix (at most 8 victims a node)."""
    before = (ts.flextopo_imp_pallas.calls, ts.flextopo_imp_pallas.overflow)
    report = run_hit_rate_experiment(
        SimConfig(num_nodes=20, seed=0, device="cpu"), "imp_pallas",
        cycles=1, scaleups_per_cycle=5)
    calls = ts.flextopo_imp_pallas.calls - before[0]
    assert report.preemptions == 5 and calls > 0
    assert ts.flextopo_imp_pallas.overflow == before[1]


def _mixed_eligibility(pkg_cluster, pkg_placement, wl_cls, spec):
    lo = wl_cls("lo", priority=100, gpus_per_instance=1,
                cores_per_instance=8, preemptible=True)
    hi = wl_cls("hi", priority=2000, gpus_per_instance=1,
                cores_per_instance=8, preemptible=True)
    mid = wl_cls("mid", priority=900, gpus_per_instance=2,
                 cores_per_instance=16, preemptible=False)
    kw = {} if pkg_cluster is RefCluster else {"device": "cpu"}
    cluster = pkg_cluster(spec, 1, **kw)
    for i in range(4):
        cluster.bind(lo if i % 2 else hi, 0, pkg_placement(1 << i, 1 << i, 0))
    cluster.bind(mid, 0, pkg_placement(0b11 << 4, 0b11 << 4, 0))
    return cluster, mid


def test_imp_pallas_mixed_eligibility_matches_reference():
    """A node mixing eligible and ineligible victims: the eligible set is a
    prefix slice and the kernel's filtering mask guards the lanes (port of
    the reference's ``test_pallas_engine_parity_with_mixed_eligibility``)."""
    from repro.core.topology import RTX4090_SERVER as REF_RTX

    ref_cluster, ref_mid = _mixed_eligibility(RefCluster, RefPlacement,
                                              RefWorkloadSpec, REF_RTX)
    want = decision_key(RefScheduler(ref_cluster, engine="imp")
                        .plan(ref_mid, allow_normal=False).decision)
    for engine in ("imp", "imp_pallas"):
        cluster, mid = _mixed_eligibility(Cluster, Placement, WorkloadSpec,
                                          RTX4090_SERVER)
        got = decision_key(TopoScheduler(cluster, engine=engine)
                           .plan(mid, allow_normal=False).decision)
        assert got == want


def _overflow_cluster(pkg_cluster, pkg_placement, spec_cls, wl_cls, policy,
                      c_workload):
    """One node with 18 preemptible victims (> MAX_DENSE_VICTIMS): GPUs held
    by 4 C instances, plus 14 cpu-only jobs."""
    spec = spec_cls(name="bigcg", num_sockets=2, num_numa=8, num_cores=192,
                    num_gpus=8, coregroup_size=8)
    cpu_job = wl_cls("cpu-only", priority=200, gpus_per_instance=0,
                     cores_per_instance=8, preemptible=True,
                     numa_policy=policy.NONE, socket_policy=policy.NONE,
                     critical=False, kind="offline")
    kw = {} if pkg_cluster is RefCluster else {"device": "cpu"}
    cluster = pkg_cluster(spec, 1, **kw)
    for i in range(4):
        mask = 0b11 << (2 * i)
        cluster.bind(c_workload, 0, pkg_placement(mask, mask, 0))
    for i in range(14):
        cluster.bind(cpu_job, 0, pkg_placement(0, 1 << (8 + i), 0))
    return cluster


def test_imp_pallas_overflow_falls_back_to_host_imp():
    """More than MAX_DENSE_VICTIMS victims: ``imp_pallas`` takes the exact
    host engine for that node and counts it (port of the reference's
    ``test_overflow_node_falls_back_instead_of_crashing``)."""
    ref_wl = {w.name: w for w in ref_table3()}
    wl = {w.name: w for w in table3_workloads()}
    ref_cluster = _overflow_cluster(RefCluster, RefPlacement, RefServerSpec,
                                    RefWorkloadSpec, RefTopoPolicy,
                                    ref_wl["C"])
    want = decision_key(RefScheduler(ref_cluster, engine="imp")
                        .plan(ref_wl["B"], allow_normal=False).decision)
    cluster = _overflow_cluster(Cluster, Placement, ServerSpec, WorkloadSpec,
                                TopoPolicy, wl["C"])
    assert len(cluster.victims_on(0, wl["B"].priority)) > MAX_DENSE_VICTIMS
    overflow = ts.flextopo_imp_pallas.overflow
    got = decision_key(TopoScheduler(cluster, engine="imp_pallas")
                       .plan(wl["B"], allow_normal=False).decision)
    assert got == want and got[0] == "preempted"
    assert ts.flextopo_imp_pallas.overflow == overflow + 1


@pytest.mark.parametrize("engine", ["imp", "imp_pallas", "godel"])
def test_plan_commit_rollback_restores_exact_state(engine):
    """plan → commit → rollback puts back every victim with its uid and
    masks, on a cluster carried over from the reference."""
    ref = ref_build(RefSimConfig(num_nodes=12, seed=2))
    cluster = Cluster.from_instances(RTX4090_SERVER, 12, instance_rows(ref),
                                     device="cpu")
    before_rows = instance_rows(cluster)
    before_masks = [cluster.free_masks(n) for n in range(12)]
    sched = TopoScheduler(cluster, engine=engine)
    wl = {w.name: w for w in table3_workloads()}["B"]
    txn = sched.plan(wl)
    assert instance_rows(cluster) == before_rows      # plan is a pure read
    dec = txn.commit()
    assert dec.preempted and dec.victims
    assert all(v not in cluster.instances for v in dec.victims)
    txn.rollback()
    assert instance_rows(cluster) == before_rows
    assert [cluster.free_masks(n) for n in range(12)] == before_masks


def test_plan_batch_composes_against_one_view():
    ref = ref_build(RefSimConfig(num_nodes=12, seed=4))
    wl = {w.name: w for w in table3_workloads()}
    ref_wl = {w.name: w for w in ref_table3()}
    names = ["B", "C", "B", "C"]
    want = [decision_key(t.decision) for t in RefScheduler(ref, engine="imp")
            .plan_batch([ref_wl[n] for n in names])]
    cluster = Cluster.from_instances(RTX4090_SERVER, 12, instance_rows(ref),
                                     device="cpu")
    for engine in ("imp", "imp_pallas"):
        got = [decision_key(t.decision)
               for t in TopoScheduler(cluster, engine=engine)
               .plan_batch([wl[n] for n in names])]
        assert got == want


@pytest.mark.parametrize("engine", ["auto", "imp_sharded",
                                    "imp_batched_legacy"])
def test_unported_engines_raise(engine, monkeypatch):
    """The three engines this case once held unported now plan: ``auto``
    at or above its node threshold (lowered here to this 12-node cluster)
    resolves to ``imp_sharded``, and each decides as the reference's host
    ``imp``; an unregistered name still raises."""
    from repro_torch.core import scheduler

    monkeypatch.setattr(scheduler, "AUTO_ENGINE_THRESHOLD", 2)
    ref = ref_build(RefSimConfig(num_nodes=12, seed=4))
    ref_wl = {w.name: w for w in ref_table3()}
    wl = {w.name: w for w in table3_workloads()}
    names = ["B", "C", "D", "B"]
    want = [decision_key(RefScheduler(ref, engine="imp").plan(
        ref_wl[n]).decision) for n in names]
    cluster = Cluster.from_instances(RTX4090_SERVER, 12, instance_rows(ref),
                                     device="cpu")
    sched = TopoScheduler(cluster, engine=engine)
    assert sched.engine == ("imp_sharded" if engine == "auto" else engine)
    assert [decision_key(sched.plan(wl[n]).decision) for n in names] == want
    with pytest.raises(UnknownEngineError):
        TopoScheduler(cluster, engine=engine + "_unported")


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & {"jax", "jaxlib", "repro"}, path
    engines = (ROOT / "src" / "repro_torch" / "core" / "engines.py")
    assert "repro.kernels" not in engines.read_text().replace(
        "repro_torch.kernels", "")


def test_sim_config_defaults_to_the_card():
    assert SimConfig().device == "cuda"
    assert dataclasses.replace(SimConfig(), device="cpu").device == "cpu"
