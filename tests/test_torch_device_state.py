"""The port's device-resident cluster state (``DeviceClusterState``,
``SourcingContext``) against a from-scratch rebuild and against the JAX
package's own resident arrays.

Ports of ``test_device_state.py``: coherence after random commit / rollback
/ plan_batch / dropped-plan sequences, one mutation as a row scatter, drain
= free ∪ victims, view deltas never touching the resident tensors, and the
op-journal replay against a full encode.  Beside them, the port's tensors
moved to numpy are held equal, field by field, to the reference's
``DeviceClusterState`` arrays on the same cluster after the same commits
and rollbacks (exact integer equality).  Every port object is built with
``device="cpu"``, where the fused engine runs its kernels' plain versions.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.topology import RTX4090_SERVER as REF_RTX  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (Cluster, DeviceClusterState,  # noqa: E402
                              SourcingContext, TopoScheduler, instance_rows,
                              table3_workloads)
from repro_torch.core.cluster import (ClusterView, encode_row,  # noqa: E402
                                      pack_rows)
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.simulator import decision_key  # noqa: E402
from repro_torch.core.topology import RTX4090_SERVER  # noqa: E402

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}


def ref_random_cluster(seed: int, nodes: int = 5) -> RefCluster:
    """The reference tests' ``random_cluster``: C and D instances with
    holes, one seeded draw sequence."""
    rng = random.Random(seed)
    cluster = RefCluster(REF_RTX, nodes)
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
                continue
            mask = sum(1 << x for x in g)
            cluster.bind(wl, node, RefPlacement(mask, mask, 0))
    return cluster


def random_cluster(seed: int, nodes: int = 5) -> Cluster:
    """The same cluster in the port (state carried across by uid)."""
    ref = ref_random_cluster(seed, nodes)
    return Cluster.from_instances(RTX4090_SERVER, nodes, instance_rows(ref),
                                  device="cpu")


def rebuilt_arrays(cluster: Cluster):
    """From-scratch host rebuild of the device layout (no incremental path)."""
    cap = cluster.sourcing_context().cap
    rows = [encode_row(cluster, n, cap) for n in range(cluster.num_nodes)]
    return pack_rows(rows, list(range(cluster.num_nodes)), cap)


def tensors(dcs) -> tuple:
    return tuple(np.asarray(x.cpu()) for x in (dcs.nodestate, dcs.victims,
                                               dcs.drain))


def assert_coherent(dcs):
    dcs.sync()
    for got, want, name in zip(tensors(dcs), rebuilt_arrays(dcs.cluster),
                               ("nodestate", "victims", "drain")):
        assert np.array_equal(got, want), f"{name} diverged"


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 8, 13])
def test_device_state_coherent_after_random_sequences(seed):
    """Random commit / rollback / plan_batch / dropped-plan sequences with
    the fused engine: the resident tensors equal a from-scratch rebuild
    after EVERY mutation."""
    rng = random.Random(1000 + seed)
    cluster = random_cluster(seed)
    sched = TopoScheduler(cluster, engine="imp_batched")
    dcs = cluster.device_state()
    assert isinstance(dcs, DeviceClusterState)
    assert_coherent(dcs)
    committed = []
    names = ["B", "C", "D"]
    for _ in range(10):
        op = rng.choice(["plan_commit", "rollback", "plan_batch",
                         "plan_drop"])
        if op == "plan_commit":
            txn = sched.plan(WL3[rng.choice(names)],
                             allow_normal=rng.random() < 0.5)
            txn.commit()
            if txn.decision:
                committed.append(txn)
        elif op == "rollback" and committed:
            committed.pop().rollback()       # LIFO: the newest is reversible
        elif op == "plan_batch":
            txns = sched.plan_batch(
                [WL3[rng.choice(names)] for _ in range(rng.randint(2, 4))])
            for t in txns:
                t.commit()
                if t.decision:
                    committed.append(t)
        else:  # a pure read must not dirty anything for real
            sched.plan(WL3[rng.choice(names)])
        assert_coherent(dcs)


def test_single_mutation_uses_row_scatter_not_full_rebuild():
    cluster = random_cluster(3, nodes=6)
    dcs = cluster.device_state()
    dcs.sync()                               # initial full upload
    before = dcs.nodestate
    kept = dcs.nodestate.clone()
    victims = cluster.victims_on(2, WL3["B"].priority)
    assert victims
    cluster.evict(victims[0].uid)            # dirties exactly one row
    assert dcs.pending == {2}
    assert_coherent(dcs)
    # the row was written in place: same tensor, other rows untouched
    assert dcs.nodestate is before
    assert torch.equal(kept[:, :2], dcs.nodestate[:, :2])
    assert torch.equal(kept[:, 3:], dcs.nodestate[:, 3:])


def test_drain_masks_are_free_union_victims():
    """Independent check of the drain field against the live instances."""
    cluster = random_cluster(7, nodes=4)
    dr = tensors(cluster.device_state().sync())[2]
    for node in range(cluster.num_nodes):
        fg, fc = cluster.free_masks(node)
        for inst in cluster.instances_on(node):
            if inst.preemptible:
                fg |= inst.gpu_mask
                fc |= inst.cg_mask
        assert dr[0, node] == fg and dr[1, node] == fc


def test_view_deltas_never_touch_resident_arrays():
    """plan() against a delta'd view reads patch rows beside the resident
    tensors; the tensors stay identical to the base cluster's."""
    cluster = random_cluster(11, nodes=4)
    sched = TopoScheduler(cluster, engine="imp_batched")
    dcs = cluster.device_state().sync()
    before = [x.clone() for x in (dcs.nodestate, dcs.victims, dcs.drain)]
    view = ClusterView(cluster)
    for wl in (WL3["B"], WL3["C"], WL3["B"]):
        sched.plan(wl, view=view, allow_normal=False)
    assert view.delta_nodes()                # the plans really stacked deltas
    assert not dcs.pending
    for x, y in zip(before, (dcs.nodestate, dcs.victims, dcs.drain)):
        assert torch.equal(x, y)
    assert_coherent(dcs)


@pytest.mark.parametrize("seed", [0, 2, 4, 6])
def test_journal_replay_matches_full_encode(seed):
    """The mirror's vectorized op-journal replay — evict→restore
    cancellation inside one window included — reproduces a from-scratch
    context exactly across all eleven dense arrays."""
    rng = random.Random(2000 + seed)
    cluster = random_cluster(seed, nodes=6)
    ctx = cluster.sourcing_context()
    ctx.refresh()                            # baseline build, journal drained
    evicted = []
    for _ in range(14):                      # one burst = one replay window
        op = rng.random()
        if op < 0.45 and cluster.instances:
            evicted.append(cluster.evict(rng.choice(sorted(cluster.instances))))
        elif op < 0.70 and evicted:
            inst = evicted.pop(rng.randrange(len(evicted)))
            fg, fc = cluster.free_masks(inst.node)
            if (fg & inst.gpu_mask) == inst.gpu_mask and \
                    (fc & inst.cg_mask) == inst.cg_mask:
                cluster.restore(inst)        # slots still free: reversible
        else:
            node = rng.randrange(cluster.num_nodes)
            fg, fc = cluster.free_masks(node)
            if fg & fc:
                g = (fg & fc) & -(fg & fc)
                cluster.bind(WL3["D"], node, Placement(g, g, 0))
    ctx.refresh()                            # incremental journal replay
    fresh = SourcingContext(cluster)
    fresh.refresh()                          # all-dirty: full re-encode
    for name in ("free_gpu", "free_cg", "vg", "vc", "vp", "vu", "rank",
                 "stored", "count", "overflow", "next_prio"):
        assert np.array_equal(getattr(ctx, name), getattr(fresh, name)), name


@pytest.mark.parametrize("seed", [1, 9, 21])
def test_resident_tensors_equal_the_reference_after_commits_and_rollbacks(
        seed):
    """The same decisions committed and rolled back in both packages (host
    ``imp``, which decides identically): after every step the port's
    nodestate / victims / drain equal the reference's resident arrays."""
    ref = ref_random_cluster(seed, nodes=6)
    port = random_cluster(seed, nodes=6)
    ref_sched = RefScheduler(ref, engine="imp")
    sched = TopoScheduler(port, engine="imp")
    ref_dcs, dcs = ref.device_state(), port.device_state()

    def check():
        want = (np.asarray(ref_dcs.sync().nodestate),
                np.asarray(ref_dcs.victims), np.asarray(ref_dcs.drain))
        for got, exp, name in zip(tensors(dcs.sync()), want,
                                  ("nodestate", "victims", "drain")):
            assert got.dtype == exp.dtype == np.int32, name
            assert np.array_equal(got, exp), name

    check()
    txns = []
    for step, name in enumerate(("B", "C", "D", "B", "C", "B", "D")):
        ref_txn = ref_sched.plan(REF_WL3[name])
        txn = sched.plan(WL3[name])
        assert decision_key(txn.decision) == decision_key(ref_txn.decision)
        ref_txn.commit()
        txn.commit()
        txns.append((ref_txn, txn))
        check()
        if step % 3 == 2:                    # roll the newest two back
            for _ in range(2):
                ref_txn, txn = txns.pop()
                ref_txn.rollback()
                txn.rollback()
                check()


def test_pending_rows_ride_as_patches():
    """``sync(flush=False)`` leaves a small dirty set pending; a plan then
    reads those rows as patch rows and decides as after a full flush."""
    cluster = random_cluster(4, nodes=6)
    flushed = random_cluster(4, nodes=6)
    for c in (cluster, flushed):
        c.device_state().sync()
        victims = c.victims_on(1, WL3["B"].priority)
        c.evict(victims[0].uid)
    flushed.device_state().sync()
    dcs = cluster.device_state().sync(flush=False)
    assert dcs.pending == {1}
    got = TopoScheduler(cluster, engine="imp_batched").plan(
        WL3["B"], allow_normal=False).decision
    want = TopoScheduler(flushed, engine="imp_batched").plan(
        WL3["B"], allow_normal=False).decision
    assert decision_key(got) == decision_key(want)
    assert got.num_candidates == want.num_candidates


def test_warmup_builds_and_plans_identically():
    cold = TopoScheduler(random_cluster(5), engine="imp_batched")
    warm = TopoScheduler(random_cluster(5), engine="imp_batched",
                         warmup=True)
    assert warm.cluster.device_state().plan_cache   # caches were filled
    d0 = cold.plan(WL3["B"], allow_normal=False).decision
    d1 = warm.plan(WL3["B"], allow_normal=False).decision
    assert decision_key(d0) == decision_key(d1)
    TopoScheduler(random_cluster(5), engine="imp", warmup=True)   # no-op


def test_device_state_lives_on_the_cluster_device():
    cluster = random_cluster(2, nodes=3)
    dcs = cluster.device_state().sync()
    assert cluster.device_state() is dcs
    for x in (dcs.nodestate, dcs.victims, dcs.drain):
        assert x.device.type == "cpu" and x.dtype == torch.int32
    assert dcs.slices.numa_gpu.device.type == "cpu"
    assert dcs.n_rows == 3 and dcs.count_max == int(
        cluster.sourcing_context().count.max())


def test_patch_rows_are_sorted_and_sentinel_padded():
    """A plan's patch rows (view deltas, then the pending rows merged in)
    travel with their node ids ascending, padded with `IDX_SENTINEL` to a
    power of two no smaller than 4: the kernels binary-search them."""
    from repro_torch.core.cluster import IDX_SENTINEL, flatten_rows
    from repro_torch.core.preemption_device import _pack_patches, _stage

    cluster = random_cluster(6, nodes=8)
    dcs = cluster.device_state().sync()
    rows = {n: encode_row(cluster, n, dcs.cap) for n in (6, 1, 3)}
    p, pidx, pbuf = _pack_patches(rows, dcs.cap)
    assert p == 4 and pidx.tolist() == [1, 3, 6, IDX_SENTINEL]
    want = flatten_rows(*pack_rows([rows[n] for n in (1, 3, 6)], [1, 3, 6],
                                   dcs.cap))
    assert np.array_equal(pbuf[:3], want) and not pbuf[3].any()
    victims = cluster.victims_on(2, WL3["B"].priority)
    cluster.evict(victims[0].uid)
    dcs.sync(flush=False)                    # row 2 stays pending
    st = _stage(dcs, rows)
    p, pidx, pbuf = st.p, st.pidx_host, st.pbuf.numpy()
    assert p == 4 and pidx.tolist() == [1, 2, 3, 6]
    assert np.array_equal(pbuf[1], flatten_rows(*rebuilt_arrays(cluster))[2])
