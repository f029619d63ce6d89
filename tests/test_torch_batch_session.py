"""The port's ``plan_batch`` sessions against the reference's decisions.

Ports of the reference's ``test_fused_sourcing.py`` batch tests (76-125)
and ``test_placement_device.py`` persistent-session tests (183-227): the
port's ``imp_batched`` (``device="cpu"``, every kernel's plain version)
plans a batch through a `BatchSourcingSession` — the class data of every
request against one snapshot, then per plan the masked merge with the
view's delta rows — and must decide as sequential single plans, as the
port's host ``imp`` and as the reference's host ``imp`` (never its live
``imp_batched``: ROADMAP.md R1), decision for decision and, against single
plans, candidate count for candidate count.  A session is reused across
``plan_batch`` calls on unchanged state and voided by any mutation.
"""
import random

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.core.workload import WorkloadSpec as RefWorkloadSpec  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (Cluster, TopoScheduler,  # noqa: E402
                              WorkloadSpec, instance_rows, table3_workloads)
from repro_torch.core.cluster import ClusterView  # noqa: E402
from repro_torch.core.preemption_device import (  # noqa: E402
    PATH_COUNTS, BatchSourcingSession, persistent_batch_session)
from repro_torch.core.simulator import decision_key  # noqa: E402
from repro_torch.core.topology import SPECS  # noqa: E402

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}


def ref_random_cluster(seed: int, nodes: int = 5) -> RefCluster:
    """The reference tests' ``random_cluster``: C and D instances with
    holes."""
    rng = random.Random(seed)
    cluster = RefCluster(REF_SPECS["rtx4090"], nodes)
    for node in range(nodes):
        free = list(range(8))
        rng.shuffle(free)
        while free:
            two = len(free) >= 2 and rng.random() < 0.4
            g = [free.pop(), free.pop()] if two else [free.pop()]
            if rng.random() < 0.2:
                continue
            mask = sum(1 << x for x in g)
            cluster.bind(REF_WL3["C" if two else "D"], node,
                         RefPlacement(mask, mask, 0))
    return cluster


def carried(ref: RefCluster) -> Cluster:
    return Cluster.from_instances(SPECS[ref.spec.name], ref.num_nodes,
                                  instance_rows(ref), device="cpu")


def batch_keys(sched, batch, commit: bool = False):
    txns = sched.plan_batch(batch)
    if commit:
        for t in txns:
            t.commit()
    return [decision_key(t.decision) for t in txns]


def test_fused_parity_in_plan_batch():
    """Later plans of a batch see earlier planned evictions and binds; the
    session masks those rows out of its class data and sweeps them again,
    and decides as host imp (test_fused_sourcing.py:76)."""
    names = ("B", "B", "C", "B")
    ref = ref_random_cluster(21, nodes=4)
    want = batch_keys(RefScheduler(ref, engine="imp"),
                      [REF_WL3[n] for n in names])
    for engine in ("imp", "imp_batched", "imp_batched_full"):
        got = batch_keys(TopoScheduler(carried(ref), engine=engine),
                         [WL3[n] for n in names])
        assert got == want, engine


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_batch_session_parity_across_engines_and_alpha(alpha):
    """8 requests against one snapshot across the alpha sweep: identical
    to host imp in both packages (test_fused_sourcing.py:90)."""
    names = ("B", "B", "C", "B", "C", "C", "B", "D")
    for seed in (3, 42):
        ref = ref_random_cluster(seed)
        want = batch_keys(RefScheduler(ref, engine="imp", alpha=alpha),
                          [REF_WL3[n] for n in names])
        before = PATH_COUNTS["merge"] + PATH_COUNTS["merge_normal"]
        got = batch_keys(TopoScheduler(carried(ref), engine="imp_batched",
                                       alpha=alpha), [WL3[n] for n in names])
        assert got == want, (seed, alpha)
        assert PATH_COUNTS["merge"] + PATH_COUNTS["merge_normal"] > before


def test_batch_session_parity_across_commit_sequences():
    """plan_batch → commit-all rounds: each round's session snapshots the
    state the commits left (test_fused_sourcing.py:106)."""
    rounds = (("B", "C", "B"), ("C", "B"), ("B", "B", "C"))
    ref = ref_random_cluster(17)
    rs = RefScheduler(ref, engine="imp")
    want = [k for r in rounds
            for k in batch_keys(rs, [REF_WL3[n] for n in r], commit=True)]
    ps = TopoScheduler(carried(ref_random_cluster(17)), engine="imp_batched")
    got = [k for r in rounds
           for k in batch_keys(ps, [WL3[n] for n in r], commit=True)]
    assert got == want


def test_batch_session_matches_sequential_single_plans():
    """The session and single plans on a shared view agree decision for
    decision and in the true evaluated-candidate counts
    (test_fused_sourcing.py:125)."""
    batch = [WL3["B"], WL3["C"], WL3["B"], WL3["B"]]
    batched = TopoScheduler(carried(ref_random_cluster(29)),
                            engine="imp_batched").plan_batch(batch)
    cluster_b = carried(ref_random_cluster(29))
    sched_b = TopoScheduler(cluster_b, engine="imp_batched")
    view = ClusterView(cluster_b)
    singles = [sched_b.plan(wl, view=view) for wl in batch]
    assert ([decision_key(t.decision) for t in batched]
            == [decision_key(t.decision) for t in singles])
    assert ([t.decision.num_candidates for t in batched]
            == [t.decision.num_candidates for t in singles])


def test_batch_session_source_path_matches_host():
    """With the blind-allocator ablation the scheduler keeps its host
    placement and reads the session's ``source`` (the merge without the
    normal cycle): decisions as host imp with the same flag."""
    names = ("B", "C", "B", "C", "B")
    ref = ref_random_cluster(8)
    want = batch_keys(RefScheduler(ref, engine="imp",
                                   topology_aware_placement=False),
                      [REF_WL3[n] for n in names])
    got = batch_keys(TopoScheduler(carried(ref), engine="imp_batched",
                                   topology_aware_placement=False),
                     [WL3[n] for n in names])
    assert got == want


def _wide_pair(seed: int):
    """An a100 cluster whose rows hold 9-16 single-GPU and CPU-only
    victims (the session's wide chunks) beside narrow rows."""
    rng = random.Random(seed)
    spec = REF_SPECS["a100"]
    ref = RefCluster(spec, 6)
    one = RefWorkloadSpec("v1", priority=100, gpus_per_instance=1,
                          cores_per_instance=spec.coregroup_size,
                          preemptible=True)
    cpu = RefWorkloadSpec("c1", priority=200, gpus_per_instance=0,
                          cores_per_instance=spec.coregroup_size,
                          preemptible=True)
    for node in range(6):
        c = list(range(spec.num_coregroups))
        rng.shuffle(c)
        for g in range(spec.num_gpus):
            if rng.random() < 0.85:
                ref.bind(one, node, RefPlacement(1 << g, 1 << c.pop(), 0))
        for _ in range(rng.choice((0, 3, 8))):
            ref.bind(cpu, node, RefPlacement(0, 1 << c.pop(), 0))
    return ref, Cluster.from_instances(SPECS["a100"], 6, instance_rows(ref),
                                       device="cpu")


def test_batch_session_with_wide_rows_matches_host():
    ref, port = _wide_pair(4)
    mk = dict(name="P", priority=1000, gpus_per_instance=2,
              cores_per_instance=2 * REF_SPECS["a100"].coregroup_size,
              preemptible=False)
    want = batch_keys(RefScheduler(ref, engine="imp"),
                      [RefWorkloadSpec(**mk)] * 4)
    got = batch_keys(TopoScheduler(port, engine="imp_batched"),
                     [WorkloadSpec(**mk)] * 4)
    assert got == want and any(k[0] == "preempted" for k in got)


# ---- persistent sessions (test_placement_device.py:183-227) -----------------------

def test_persistent_session_reused_across_plan_batch_calls():
    cluster = carried(ref_random_cluster(13))
    s1 = persistent_batch_session(cluster, (WL3["B"], WL3["C"]), 0.5)
    s2 = persistent_batch_session(cluster, (WL3["B"], WL3["C"]), 0.5)
    assert s1 is s2, "clean state + same request classes must reuse"
    s3 = persistent_batch_session(cluster, (WL3["C"], WL3["B"]), 0.5)
    assert s3 is not s2
    s4 = persistent_batch_session(cluster, (WL3["C"], WL3["B"]), 0.3)
    assert s4 is not s3
    # one sweep a distinct request: B, B, C gives two slabs
    s5 = BatchSourcingSession(cluster, (WL3["B"], WL3["B"], WL3["C"]), 0.5)
    assert s5.class_data.shape == (2, 15, cluster.num_nodes)
    assert s5._slot == [0, 0, 1]


def test_persistent_session_invalidated_by_mutation():
    cluster = carried(ref_random_cluster(17))
    s1 = persistent_batch_session(cluster, (WL3["B"], WL3["B"]), 0.5)
    sched = TopoScheduler(cluster, engine="imp_batched")
    sched.plan(WL3["B"], allow_normal=False).commit()
    s2 = persistent_batch_session(cluster, (WL3["B"], WL3["B"]), 0.5)
    assert s2 is not s1, "any invalidate_node must void the cached session"


def test_persistent_session_parity_across_repeated_plan_batch():
    """Repeated identical bursts (pure reads, the session reused) stay
    identical to host imp every round."""
    names = ("B", "C", "B")
    want = batch_keys(RefScheduler(ref_random_cluster(23), engine="imp"),
                      [REF_WL3[n] for n in names])
    sched = TopoScheduler(carried(ref_random_cluster(23)),
                          engine="imp_batched")
    before = PATH_COUNTS["sessions"]
    for _ in range(3):
        assert batch_keys(sched, [WL3[n] for n in names]) == want
    assert PATH_COUNTS["sessions"] - before <= 1


def test_persistent_session_parity_across_commit_bursts():
    """Bursts separated by commits: the session rebuilds after each commit
    and the whole sequence matches host imp."""
    seqs = {}
    for pkg, engine in (("ref", "imp"), ("port", "imp"),
                        ("port", "imp_batched")):
        ref = ref_random_cluster(8, nodes=4)
        if pkg == "ref":
            sched, wls = RefScheduler(ref, engine=engine), REF_WL3
        else:
            sched, wls = TopoScheduler(carried(ref), engine=engine), WL3
        seq = []
        for _ in range(3):
            seq.extend(batch_keys(sched, [wls["B"], wls["C"], wls["B"]],
                                  commit=True))
        seqs[(pkg, engine)] = seq
    assert len(set(map(tuple, seqs.values()))) == 1, seqs
