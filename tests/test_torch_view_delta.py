"""The port's device view-delta encoder against the reference's.

* `ViewDelta` (``repro_torch.core.cluster``) against the reference's on the
  same random views (planned evictions, binds and cancelled binds, over
  rows with pending base changes and rows past the encoder's gates): the
  same dense and fallback nodes, the same descriptors, and the same
  routing metadata as host ``encode_row`` rows give.
* The plain encoder (``kernels.view_delta.encode_delta_core``) against the
  reference's ``encode_delta_core`` called eagerly on the same
  descriptors and resident arrays, and against the host ``encode_row``
  packing of the view: exact int32 equality.
* The staged patch buffer of a plan (`preemption_device._stage`: the
  encoder's rows, the host-encoded fallback and pending rows, each at its
  row of the ascending index) against the host packing of every delta and
  pending row.
* The reference's ``test_device_state.py`` ViewDelta tests, ported.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core.cluster import ClusterView as RefView  # noqa: E402
from repro.core.cluster import ViewDelta as RefViewDelta  # noqa: E402
from repro.core.cluster import encode_delta_core as ref_encode  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.core.topology import ServerSpec as RefServerSpec  # noqa: E402
from repro.core.workload import WorkloadSpec as RefWorkloadSpec  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (Cluster, ServerSpec, TopoScheduler,  # noqa: E402
                              WorkloadSpec, instance_rows, table3_workloads)
from repro_torch.core.cluster import (ADD_FIELDS, DD_POS,  # noqa: E402
                                      DENSE_FIELDS, IDX_SENTINEL,
                                      ClusterView, ViewDelta, encode_row,
                                      flatten_rows, pack_context_rows,
                                      pack_rows, row_width)
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.preemption_device import (_patch_elig,  # noqa: E402
                                                _patch_rows, _stage)
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels.view_delta import (encode_delta,  # noqa: E402
                                            encode_delta_core)

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}
BIG_CG = dict(name="bigcg", num_sockets=2, num_numa=8, num_cores=192,
              num_gpus=8, coregroup_size=8)   # 24 CoreGroups
PORT_BIG, REF_BIG = ServerSpec(**BIG_CG), RefServerSpec(**BIG_CG)
#: a preemptible one-CoreGroup job: many fit a node, so rows fill past cap
CPU_JOB = dict(name="cpu-only", priority=150, gpus_per_instance=0,
               cores_per_instance=8, preemptible=True, critical=False,
               kind="offline")


def _jobs(wl_cls):
    return {"cpu": wl_cls(**CPU_JOB)}


def _random_pair(seed: int, big: bool, nodes: int = 6):
    """The same random cluster in both packages: C and D instances with
    holes and, on the 24-CoreGroup SKU, one-CoreGroup jobs on the free
    CoreGroups (rows of up to 24 victims: some past cap)."""
    rng = random.Random(seed)
    spec = REF_BIG if big else REF_SPECS["rtx4090"]
    ref = RefCluster(spec, nodes)
    cpu = _jobs(RefWorkloadSpec)["cpu"]
    for node in range(nodes):
        free = list(range(8))
        rng.shuffle(free)
        while free:
            two = len(free) >= 2 and rng.random() < 0.4
            g = [free.pop(), free.pop()] if two else [free.pop()]
            if rng.random() < 0.2:
                continue
            mask = sum(1 << x for x in g)
            ref.bind(REF_WL3["C" if two else "D"], node,
                     RefPlacement(mask, mask, 0))
        if big:
            for c in range(8, 24):
                if rng.random() < 0.7:
                    ref.bind(cpu, node, RefPlacement(0, 1 << c, 0))
    port = Cluster.from_instances(PORT_BIG if big else SPECS["rtx4090"],
                                  nodes, instance_rows(ref), device="cpu")
    return ref, port


def _mutate_base(rng, clusters, steps: int) -> None:
    """The same committed changes on both clusters (they leave pending
    rows behind ``sync(flush=False)``)."""
    for _ in range(steps):
        uids = sorted(clusters[0].instances)
        if uids and rng.random() < 0.6:
            uid = rng.choice(uids)
            for c in clusters:
                c.evict(uid)


def _random_views(rng, ref, port, ops: int):
    """The same planned evictions, binds and cancelled binds on a view of
    each cluster (virtual uids agree: both count down from -1)."""
    views = (RefView(ref), ClusterView(port))
    wls = ((REF_WL3, _jobs(RefWorkloadSpec), RefPlacement),
           (WL3, _jobs(WorkloadSpec), Placement))
    added: list[int] = []
    for _ in range(ops):
        op = rng.random()
        if op < 0.4:
            live = sorted(u for u in ref.instances if u not in
                          views[0]._evicted)
            if not live:
                continue
            uid = rng.choice(live)
            for v in views:
                v.plan_evict(uid)
        elif op < 0.55 and added:
            uid = added.pop(rng.randrange(len(added)))
            for v in views:
                v.plan_evict(uid)
        else:
            node = rng.randrange(ref.num_nodes)
            fg, fc = views[0].free_masks(node)
            if rng.random() < 0.5 and fg & fc:
                bit = (fg & fc) & -(fg & fc)
                name, g, c = "D", bit, bit
            elif fc >> 8:
                c = (fc >> 8 & -(fc >> 8)) << 8
                name, g = "cpu", 0
            else:
                continue
            uids = []
            for v, (w3, jobs, pl) in zip(views, wls):
                wl = jobs["cpu"] if name == "cpu" else w3[name]
                uids.append(v.plan_bind(wl, node, pl(g, c, 0)).uid)
            assert uids[0] == uids[1]
            added.append(uids[0])
    return views


def _case(seed: int, big: bool, pending: bool):
    rng = random.Random(100 + seed)
    ref, port = _random_pair(seed, big)
    rdcs, dcs = ref.device_state().sync(), port.device_state().sync()
    if pending:
        _mutate_base(rng, (ref, port), 3)
        rdcs.sync(flush=False)
        dcs.sync(flush=False)
    rview, view = _random_views(rng, ref, port, 14)
    return ref, port, rdcs, dcs, rview, view


CASES = [(seed, big, pending) for seed in range(4) for big in (False, True)
         for pending in (False, True)]


@pytest.mark.parametrize("seed,big,pending", CASES)
def test_view_delta_descriptors_match_reference(seed, big, pending):
    _, _, rdcs, dcs, rview, view = _case(seed, big, pending)
    assert dcs.pending == rdcs.pending
    rvd = RefViewDelta(rview, rdcs.mirror, rdcs.pending)
    vd = ViewDelta(view, dcs.mirror, dcs.pending)
    assert sorted(vd) == sorted(rvd) and len(vd) == len(rvd)
    assert vd.dense.tolist() == rvd.dense.tolist()
    assert sorted(vd.fallback) == sorted(rvd.fallback)
    assert vd.a == rvd.a
    d = len(vd.dense)
    desc, adds = vd.descriptors(np.arange(d, dtype=np.int32))
    assert desc.shape == (DENSE_FIELDS, d) and adds.shape == (ADD_FIELDS, d,
                                                              vd.a)
    want = np.stack([rvd.dense, rvd.rem, rvd.fog, rvd.foc, rvd.og, rvd.oc])
    assert np.array_equal(desc[:DD_POS], want)
    assert np.array_equal(adds, np.stack([rvd.addg, rvd.addc, rvd.addp,
                                          rvd.addv]))
    for thresh in (0, 150, 600, 1000, 10**6):
        assert vd.elig_bad(thresh) == rvd.elig_bad(thresh)
        # and what host-encoded rows of the view give
        rows = {n: encode_row(view, n, dcs.cap) for n in vd}
        assert vd.elig_bad(thresh) == _patch_elig(rows, thresh)
    for node in vd:
        assert vd.count(node) == rvd.count(node) == encode_row(
            view, node, dcs.cap).count


@pytest.mark.parametrize("seed,big,pending", CASES)
def test_encode_delta_core_matches_reference_and_host(seed, big, pending):
    _, _, rdcs, dcs, rview, view = _case(seed, big, pending)
    vd = ViewDelta(view, dcs.mirror, dcs.pending)
    d = len(vd.dense)
    if not d:
        pytest.skip("no dense delta row in this draw")
    desc, adds = vd.descriptors(np.arange(d, dtype=np.int32))
    cap = dcs.cap
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (*desc[:DD_POS],
                                                             *adds)]
    got = encode_delta_core(dcs.nodestate, dcs.victims, *t, cap=cap,
                            a=vd.a).numpy()
    want = np.asarray(ref_encode(
        rdcs.nodestate, rdcs.victims, *[jnp.asarray(x) for x in
                                        (*desc[:DD_POS], *adds)],
        cap=cap, a=vd.a))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    nodes = vd.dense.tolist()
    host = flatten_rows(*pack_rows([encode_row(view, n, cap) for n in nodes],
                                   nodes, cap))
    assert np.array_equal(got, host)


@pytest.mark.parametrize("seed,big,pending", CASES)
def test_staged_patch_buffer_matches_host_packing(seed, big, pending):
    """A plan's patch buffer built by the encoder (dense rows) and copied
    host rows (fallback and pending) equals the host packing of every row,
    node ids ascending, sentinel-padded; the tail rides the upload."""
    _, port, _, dcs, _, view = _case(seed, big, pending)
    vd = ViewDelta(view, dcs.mirror, dcs.pending)
    tail = np.array([5, 7, IDX_SENTINEL], np.int32)
    st = _stage(dcs, vd, tail)
    rows = {n: encode_row(view, n, dcs.cap) for n in vd}
    left = sorted(set(dcs.pending) - set(rows))
    p, pidx, pbuf = _patch_rows(rows, dcs.mirror, left, dcs.cap)
    assert st.p == p and st.pidx_host.tolist() == pidx.tolist()
    assert st.pidx.tolist() == pidx.tolist()
    assert np.array_equal(st.pbuf.numpy(), pbuf)
    assert st.tail.tolist() == tail.tolist()
    if left:
        want = flatten_rows(*pack_context_rows(dcs.mirror, left))
        at = [pidx.tolist().index(n) for n in left]
        assert np.array_equal(st.pbuf.numpy()[at], want)


def test_encode_delta_places_rows_and_checks_shapes():
    """The wrapper writes dense rows and host rows at their positions and
    zeroes the rest; malformed descriptors raise."""
    ref, port = _random_pair(3, big=True)
    dcs = port.device_state().sync()
    rng = random.Random(5)
    _, view = _random_views(rng, ref, port, 10)
    vd = ViewDelta(view, dcs.mirror, dcs.pending)
    d = len(vd.dense)
    assert d
    cap, width = dcs.cap, row_width(dcs.cap)
    hrows = torch.arange(2 * width, dtype=torch.int32).reshape(2, width)
    pos = np.arange(d, dtype=np.int32)[::-1] + 2      # reversed, after hosts
    desc, adds = vd.descriptors(pos)
    out = encode_delta(dcs.nodestate, dcs.victims, torch.from_numpy(desc),
                       torch.from_numpy(np.ascontiguousarray(adds)),
                       torch.tensor([1, 0], dtype=torch.int32), hrows,
                       p=d + 4)
    nodes = vd.dense.tolist()
    host = flatten_rows(*pack_rows([encode_row(view, n, cap) for n in nodes],
                                   nodes, cap))
    assert torch.equal(out[:2], hrows.flip(0))
    assert np.array_equal(out[2:2 + d].numpy(), host[::-1])
    assert not out[2 + d:].any()
    with pytest.raises(ValueError):
        encode_delta(dcs.nodestate, dcs.victims, torch.from_numpy(desc[:6]),
                     torch.from_numpy(np.ascontiguousarray(adds)), p=d)
    with pytest.raises(ValueError):
        encode_delta(dcs.nodestate, dcs.victims, torch.from_numpy(desc),
                     torch.from_numpy(np.ascontiguousarray(adds)),
                     p=d - 1)


# ---- ports of the reference's test_device_state.py ViewDelta tests ----------------

def _rebuilt(cluster):
    cap = cluster.sourcing_context().cap
    nodes = list(range(cluster.num_nodes))
    return pack_rows([encode_row(cluster, n, cap) for n in nodes], nodes, cap)


def test_view_deltas_never_touch_resident_arrays():
    """plan() against a delta'd view reads patch rows; the resident tensors
    must stay identical to the base cluster (the reference's
    test_device_state.py:127)."""
    _, cluster = _random_pair(11, big=False, nodes=4)
    sched = TopoScheduler(cluster, engine="imp_batched")
    dcs = cluster.device_state()
    view = ClusterView(cluster)
    for wl in (WL3["B"], WL3["C"], WL3["B"]):
        sched.plan(wl, view=view, allow_normal=False)
    assert view.delta_nodes()
    dcs.sync()
    for got, want in zip((dcs.nodestate, dcs.victims, dcs.drain),
                         _rebuilt(cluster)):
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 4, 9, 12])
def test_view_delta_device_rows_match_host_encode(seed):
    """Dense `ViewDelta` rows rebuilt by the device delta encoder equal the
    host ``encode_row`` packing of the same view (the reference's
    test_device_state.py:214)."""
    _, cluster = _random_pair(seed, big=False)
    sched = TopoScheduler(cluster, engine="imp_batched")
    dcs = cluster.device_state().sync()
    view = ClusterView(cluster)
    for wl in (WL3["B"], WL3["C"], WL3["B"]):
        sched.plan(wl, view=view, allow_normal=False)
    assert view.delta_nodes()
    vd = ViewDelta(view, dcs.mirror, dcs.pending)
    got = vd.device_rows(dcs)
    assert got is not None, "expected dense rows for this seed"
    didx, buf = got
    d = len(vd.dense)
    cap = dcs.cap
    nodes = [int(n) for n in didx[:d]]
    want = flatten_rows(*pack_rows(
        [encode_row(view, n, cap) for n in nodes], nodes, cap))
    assert np.array_equal(buf.numpy()[:d], want)
    assert not buf[d:].any() and (didx[d:] == IDX_SENTINEL).all()
