"""Decisions of the port's fused ``imp_batched`` on every SKU.

The port's ``imp_batched`` (``device="cpu"``: every kernel's plain version)
against the reference's host ``imp`` (never its live ``imp_batched``, which
the R1 miscompile breaks; see ROADMAP.md), decision for decision, on random
``a100`` and ``tpu_v5e_host`` clusters: random instance sizes and holes,
preemptors with random NUMA and socket policies, alpha in {0, 0.3, 0.5, 1},
``allow_normal`` on and off, and ``plan_batch`` / commit / rollback /
replan sequences.  The key is kind, node, victims, tier, hit and the GPU /
CoreGroup masks.

``a100`` servers (8 GPUs, 16 CoreGroups) hold up to 16 victims a node, so
rows with 9 to 16 eligible victims occur: they are decided by the 16-slot
wide chunks, one Eq. 2 winner a segment of `MAX_ROWS_WIDE` rows
(``_chunked``), and the clusters here hold more wide rows than one segment.
"""
import random

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.core.workload import TopoPolicy as RefTopoPolicy  # noqa: E402
from repro.core.workload import WorkloadSpec as RefWorkloadSpec  # noqa: E402
from repro_torch.core import (Cluster, TopoPolicy, TopoScheduler,  # noqa: E402
                              WorkloadSpec, instance_rows)
from repro_torch.core.preemption_device import (MAX_ROWS_WIDE,  # noqa: E402
                                                split_fused_nodes)
from repro_torch.core.simulator import decision_key  # noqa: E402
from repro_torch.core.topology import SPECS  # noqa: E402

SKUS = ("a100", "tpu_v5e_host")
ALPHAS = (0.0, 0.3, 0.5, 1.0)
POLICIES = ("guaranteed", "best_effort", "none")


def _full_key(dec):
    return decision_key(dec) + (
        None if dec.placement is None else
        (dec.placement.gpu_mask, dec.placement.cg_mask),)


def _carried(ref: RefCluster) -> Cluster:
    return Cluster.from_instances(SPECS[ref.spec.name], ref.num_nodes,
                                  instance_rows(ref), device="cpu")


def _workload(ref: bool, **kw):
    """The same workload class in the reference's or the port's types."""
    cls, policy = ((RefWorkloadSpec, RefTopoPolicy) if ref
                   else (WorkloadSpec, TopoPolicy))
    kw = dict(kw)
    kw["numa_policy"] = policy(kw.get("numa_policy", "guaranteed"))
    kw["socket_policy"] = policy(kw.get("socket_policy", "best_effort"))
    return cls(**kw)


def _random_cluster(sku: str, seed: int, nodes: int, wide: float = 0.0
                    ) -> RefCluster:
    """A reference cluster of ``nodes`` servers filled by random instances:
    1-3 GPUs with or without CoreGroups, CPU-only ones, random priorities
    (some not preemptible), random holes.  A share ``wide`` of the nodes
    is filled with single-GPU and CPU-only victims only, one CoreGroup
    each, which gives 9-16 victims on an ``a100`` row."""
    spec = REF_SPECS[sku]
    rng = random.Random(seed)
    cluster = RefCluster(spec, nodes)
    cgs = spec.num_coregroups
    for node in range(nodes):
        free_g = list(range(spec.num_gpus))
        free_c = list(range(cgs))
        rng.shuffle(free_g)
        rng.shuffle(free_c)
        small = rng.random() < wide
        while free_g or free_c:
            if small:
                ng = 1 if free_g and rng.random() < 0.5 else 0
                nc = 1 if free_c else 0
            else:
                ng = min(len(free_g), rng.choice((0, 1, 1, 2, 2, 3)))
                nc = min(len(free_c), rng.choice((0, 1, 1, 2)))
            if ng == 0 and nc == 0:
                if not free_c:
                    break
                nc = 1
            g = [free_g.pop() for _ in range(ng)]
            c = [free_c.pop() for _ in range(nc)]
            if rng.random() < (0.05 if small else 0.2):
                continue  # leave a hole
            wl = _workload(
                True, name=f"v{ng}{nc}", priority=rng.choice(
                    (1, 2, 3, 100, 200, 450, 900, 5000)),
                gpus_per_instance=ng,
                cores_per_instance=nc * spec.coregroup_size,
                preemptible=rng.random() < 0.9,
                numa_policy=rng.choice(POLICIES),
                socket_policy=rng.choice(POLICIES))
            cluster.bind(wl, node, RefPlacement(
                sum(1 << x for x in g), sum(1 << x for x in c), 0))
    return cluster


def _preemptor(sku: str, rng: random.Random) -> dict:
    spec = REF_SPECS[sku]
    return dict(name="P", priority=rng.choice((1000, 300, 5000)),
                gpus_per_instance=rng.choice(
                    [g for g in (1, 2, 4) if g <= spec.num_gpus]),
                cores_per_instance=spec.coregroup_size * rng.choice((0, 1, 2)),
                preemptible=False, numa_policy=rng.choice(POLICIES),
                socket_policy=rng.choice(POLICIES))


@pytest.mark.parametrize("sku", SKUS)
@pytest.mark.parametrize("seed", range(4))
def test_single_plans_match_host_imp(sku, seed):
    """Single plans on random clusters: every alpha, the normal cycle on
    and off, a fresh preemptor each time."""
    rng = random.Random(100 * seed + len(sku))
    ref = _random_cluster(sku, seed, nodes=6, wide=0.3)
    port = _carried(ref)
    for alpha in ALPHAS:
        for allow_normal in (True, False):
            kw = _preemptor(sku, rng)
            want = _full_key(RefScheduler(ref, engine="imp", alpha=alpha)
                             .plan(_workload(True, **kw),
                                   allow_normal=allow_normal).decision)
            got = _full_key(TopoScheduler(port, engine="imp_batched",
                                          alpha=alpha)
                            .plan(_workload(False, **kw),
                                  allow_normal=allow_normal).decision)
            assert got == want, (sku, seed, alpha, allow_normal, kw)


@pytest.mark.parametrize("alpha", (0.0, 0.5, 1.0))
def test_a100_wide_rows_over_two_segments_match_host_imp(alpha):
    """``a100`` rows with 9-16 eligible victims, more of them than one
    `MAX_ROWS_WIDE` segment: the wide chunks decide them, and the plans
    agree with host ``imp`` with the normal cycle on and off."""
    ref = _random_cluster("a100", 7, nodes=MAX_ROWS_WIDE + 6, wide=0.9)
    port = _carried(ref)
    kw = dict(name="P", priority=1000, gpus_per_instance=2,
              cores_per_instance=16, preemptible=False)
    split = split_fused_nodes(port.device_state().sync(), {}, kw["priority"])
    assert len(split.wide) > MAX_ROWS_WIDE and not split.overflow, split
    for allow_normal in (True, False):
        for policy in POLICIES:
            kw.update(numa_policy=policy)
            want = _full_key(RefScheduler(ref, engine="imp", alpha=alpha)
                             .plan(_workload(True, **kw),
                                   allow_normal=allow_normal).decision)
            got = _full_key(TopoScheduler(port, engine="imp_batched",
                                          alpha=alpha)
                            .plan(_workload(False, **kw),
                                  allow_normal=allow_normal).decision)
            assert got == want, (alpha, allow_normal, policy)
    assert want[0] == "preempted"


@pytest.mark.parametrize("sku", SKUS)
@pytest.mark.parametrize("seed", (0, 1))
def test_batch_commit_rollback_replan_sequences_match_host_imp(sku, seed):
    """``plan_batch`` against one snapshot, then commits and rollbacks of
    some of its plans, then plans again on the changed cluster: the same
    decisions as host ``imp`` at every step."""
    keys = {}
    for who in ("ref", "port"):
        rng = random.Random(seed)
        ref = _random_cluster(sku, 50 + seed, nodes=5, wide=0.3)
        cluster = ref if who == "ref" else _carried(ref)
        sched = (RefScheduler(cluster, engine="imp", alpha=0.5)
                 if who == "ref" else
                 TopoScheduler(cluster, engine="imp_batched", alpha=0.5))
        seq = []
        for _ in range(3):
            kws = [_preemptor(sku, rng) for _ in range(3)]
            txns = sched.plan_batch([_workload(who == "ref", **kw)
                                     for kw in kws])
            seq.extend(_full_key(t.decision) for t in txns)
            done = [t for t in txns if not t.decision.rejected]
            for t in done:
                t.commit()
            if done:
                done[-1].rollback()        # undo the last of the batch
            kw = _preemptor(sku, rng)
            seq.append(_full_key(sched.plan(
                _workload(who == "ref", **kw)).decision))
        keys[who] = seq
    assert keys["port"] == keys["ref"]
    assert any(k[0] == "preempted" for k in keys["ref"])
