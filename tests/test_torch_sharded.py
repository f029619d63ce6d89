"""The sharded state and the ``imp_sharded`` engine of the port, on the CPU.

A mesh here is ``("cpu",) * D``: D shards of the node axis on one device,
in place of the reference's ``--xla_force_host_platform_device_count``
(``tests/test_distributed.py``).  Every kernel runs its plain version.

* The layout: the node axis padded to a multiple of D, each shard's rows
  (pads with `IDX_SENTINEL` ids and zero masks), kept through a scatter
  and a full rebuild (port of ``test_sharded_state_layout_and_scatter``).
* The merges against the unsharded kernels' plain versions, bit for bit:
  the tail's shard records merged by ``tail_merge`` against the tail over
  all rows (and against a numpy model of the reference's tie chain, with
  forced cross-shard ties, the same-tier case among them); the normal
  cycle's shard records merged by ``normal_merge`` against the normal
  cycle; the shards' prescreen keys merged by ``prescreen_select`` against
  the prescreen over all rows.
* Decisions: ``imp_sharded`` and ``imp_sharded_full`` with D in {1, 2, 3,
  4, 8} over the reference's randomized plan / commit / rollback /
  ``plan_batch`` sequences at 5, 11 and 13 nodes, held to the reference's
  host ``imp`` (never its live ``imp_batched``, R1 in ROADMAP.md): node,
  victims, tier, masks and candidate count; wide, overflow and truncated
  rows; a 12-node 5-hour day at D = 4 against the reference's ``imp`` day.
* The distributed functions against the reference's unsharded
  ``_source_best``, ``_sorting_winner`` and ``normal_cycle_core``, run
  eagerly.
"""
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import colocation as ref_coloc  # noqa: E402
from repro.core.cluster import Cluster as RefCluster  # noqa: E402
from repro.core.cluster_parallel import \
    _source_best as ref_source_best  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.placement_jax import \
    normal_cycle_core as ref_normal_cycle  # noqa: E402
from repro.core.preemption_jax import Request as RefRequest  # noqa: E402
from repro.core.preemption_jax import \
    _sorting_winner as ref_sorting_winner  # noqa: E402
from repro.core.preemption_jax import spec_constants  # noqa: E402
from repro.core.scheduler import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (Cluster, TopoScheduler,  # noqa: E402
                              instance_rows, table3_workloads)
from repro_torch.core import cluster_parallel as cp  # noqa: E402
from repro_torch.core.cluster import (IDX_SENTINEL,  # noqa: E402
                                      DeviceClusterState)
from repro_torch.core.colocation import (ColocationConfig,  # noqa: E402
                                         ColocationSim, default_policies)
from repro_torch.core.preemption_device import Request  # noqa: E402
from repro_torch.core.simulator import (SimConfig,  # noqa: E402
                                        build_saturated_cluster,
                                        decision_key)
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels.fused_class import (C_ANY, C_CB, C_CNT,  # noqa: E402
                                             C_K, C_NID, C_PP, C_UM,
                                             CLS_FIELDS, FusedRequest,
                                             fused_argmax_plain)
from repro_torch.kernels.fused_class import (fused_argmax,  # noqa: E402
                                             tail_merge)
from repro_torch.kernels.normal_cycle import (normal_cycle_part,  # noqa: E402
                                              normal_cycle_plain,
                                              normal_merge)
from repro_torch.kernels.prescreen import (prescreen,  # noqa: E402
                                           prescreen_plain, prescreen_select)
from repro_torch.core import preemption_device as pd  # noqa: E402

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}
INT32_MAX = 2**31 - 1
MESHES = (1, 2, 3, 4, 8)


def mesh(d: int):
    return ("cpu",) * d


# ---------------------------------------------------------------------------------
# Random resident states, split into shards
# ---------------------------------------------------------------------------------

def random_state(spec, rows: int, seed: int, max_victims: int = 6,
                 cap: int = 16):
    """Resident rows as the allocator leaves them (one node's masks
    disjoint), victims sorted by priority, ranks a permutation."""
    rng = np.random.default_rng(seed)
    ns = np.zeros((5, rows), np.int32)
    v = np.zeros((5, rows, cap), np.int32)
    for r in range(rows):
        s = int(rng.integers(0, max_victims + 1))
        own_g = rng.integers(-1, s + 1, spec.num_gpus)
        own_c = rng.integers(-1, s + 1, spec.num_coregroups)
        prio = np.sort(rng.choice([1, 2, 3, 200, 200, 700], s))
        ranks = rng.permutation(s)
        for j in range(s):
            v[0, r, j] = sum(1 << i for i in np.nonzero(own_g == j + 1)[0])
            v[1, r, j] = sum(1 << i for i in np.nonzero(own_c == j + 1)[0])
            v[2, r, j], v[3, r, j], v[4, r, j] = prio[j], ranks[j], 1
        ns[0, r] = sum(1 << i for i in np.nonzero(own_g == 0)[0])
        ns[1, r] = sum(1 << i for i in np.nonzero(own_c == 0)[0])
        ns[2, r] = r
        ns[4, r] = INT32_MAX
    dr = np.stack([ns[0] | np.bitwise_or.reduce(v[0], axis=1),
                   ns[1] | np.bitwise_or.reduce(v[1], axis=1)])
    return ns, v, dr


def padded(x: np.ndarray, rows: int, sentinel_row: int | None = None):
    out = np.zeros(x.shape[:1] + (rows,) + x.shape[2:], np.int32)
    out[:, :x.shape[1]] = x
    if sentinel_row is not None:
        out[sentinel_row, x.shape[1]:] = IDX_SENTINEL
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


EMPTY = (torch.zeros(0, dtype=torch.int32),
         torch.zeros((0, 5 + 5 * 16 + 2), dtype=torch.int32))


# ---------------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("d", [3, 8])
def test_sharded_state_layout_and_scatter(d):
    """13 nodes over D shards: the node axis padded to a multiple of D,
    shard k holding rows k * rows onwards (pads: sentinel ids, zero
    masks), equal to the unsharded state row for row, through a scatter
    (an eviction) and a full rebuild (every row dirty); the unsharded state
    it replaced stops listening for invalidations."""
    cluster = build_saturated_cluster(SimConfig(num_nodes=13, seed=2,
                                                device="cpu"))
    flat0 = cluster.device_state()
    dcs = cluster.device_state(mesh=mesh(d))
    assert isinstance(dcs, cp.ShardedDeviceClusterState)
    assert cluster.device_state(sharded=True) is dcs
    # the replaced state no longer hears invalidations; the installed one
    # does
    assert flat0._mark_dirty not in cluster._dirty_listeners
    assert dcs._mark_dirty in cluster._dirty_listeners
    dcs.sync()
    rows = -(-13 // d)
    assert dcs.n_rows == rows * d and dcs.nodestate.shape[1] == rows * d
    assert [s.base for s in dcs.shards] == [k * rows for k in range(d)]

    def check():
        flat = DeviceClusterState(cluster).sync()
        for s in dcs.shards:
            assert s.nodestate.shape == (5, rows) and s.device.type == "cpu"
            for name in ("nodestate", "victims", "drain"):
                want = padded(getattr(flat, name).numpy(), rows * d,
                              2 if name == "nodestate" else None)
                got = getattr(s, name).numpy()
                assert np.array_equal(got, want[:, s.base:s.base + rows]), (
                    name, s.base)

    check()
    uid = next(iter(cluster.instances))
    cluster.evict(uid)
    dcs.sync()
    check()
    dcs._dirty.update(range(cluster.num_nodes))
    dcs.sync()
    check()
    rep_host, rep_dev = dcs.rep_classes()
    assert rep_host.shape == (rows * d,) and not rep_host[13:].any()
    assert np.array_equal(np.concatenate([r.numpy() for r in rep_dev]),
                          rep_host.astype(np.int32))


# ---------------------------------------------------------------------------------
# The tail's records and their merge
# ---------------------------------------------------------------------------------

def model_winner(cls: np.ndarray, alpha: float):
    """The reference's tie chain (``_fused_argmax_core``) over every (row,
    tier) entry of ``cls`` in numpy f32: ``(found, row, tier, combo, pp,
    k, count)``."""
    a32, b32 = np.float32(alpha), np.float32(1.0 - alpha)
    tv = np.asarray([1.0, 0.5, 0.1], np.float32)
    ents = []
    for r in range(cls.shape[1]):
        for t in range(3):
            if cls[C_ANY + t, r]:
                pp = int(cls[C_PP + t, r])
                term = (np.float32(1.0) / np.float32(max(pp, 1)) if pp > 0
                        else np.float32(1.0))
                ents.append((np.float32(a32 * term) + np.float32(b32 * tv[t]),
                             r, t))
    cnt = int(cls[C_CNT].astype(np.int64).sum()) & 0xFFFFFFFF
    cnt -= (cnt >> 31) << 32
    if not ents:
        return (0, 0, 0, int(cls[C_CB, 0]), int(cls[C_PP, 0]),
                int(cls[C_K, 0]), cnt)
    top = max(e[0] for e in ents)
    at = [(r, t) for s, r, t in ents if s == top]
    same = len({t for _, t in at}) == 1

    def key(e):
        r, t = e
        ppe = int(cls[C_PP + t, r]) if (same and alpha > 0) else 0
        return (ppe, int(cls[C_K, r]), int(cls[C_NID, r]),
                -int(cls[C_UM + t, r]), 3 * r + t)

    r, t = min(at, key=key)
    return (1, r, t, int(cls[C_CB + t, r]), int(cls[C_PP + t, r]),
            int(cls[C_K, r]), cnt)


def random_cls(ns: np.ndarray, seed: int, cap: int) -> np.ndarray:
    """Class winners with forced exact ties: tiers 0 and 1 at the same
    score (alpha 0.5: a priority sum of 2 at tier 0, 1 at tier 1), few
    distinct k, node ids and uid masks; pad rows hold no class."""
    rng = np.random.default_rng(seed)
    rows = ns.shape[1]
    cls = np.zeros((CLS_FIELDS, rows), np.int32)
    real = ns[2] < IDX_SENTINEL
    for t in range(3):
        cls[C_ANY + t] = (rng.random(rows) < 0.35) & real
        cls[C_CB + t] = rng.integers(0, 1 << min(cap, 6), rows)
        cls[C_UM + t] = rng.choice([1 << 15, 1 << 14, 3 << 13], rows)
    cls[C_PP] = rng.choice([2, 2, 400], rows)
    cls[C_PP + 1] = rng.choice([1, 1, 300], rows)
    cls[C_PP + 2] = rng.choice([1, 50], rows)
    cls[C_K] = rng.choice([1, 2], rows)
    cls[C_CNT] = rng.integers(0, 5, rows)
    cls[C_NID] = ns[2]
    return cls


def sharded_tail(cls, ns, v, d: int, req, spec):
    """Each shard's tail records over its rows of ``cls`` (a resident
    segment), then `tail_merge`."""
    n = cls.shape[1]
    rows = n // d
    part = torch.stack([fused_argmax(
        _t(cls[:, k * rows:(k + 1) * rows]), _t(ns[:, k * rows:(k + 1) * rows]),
        _t(v[:, k * rows:(k + 1) * rows]), EMPTY[0], EMPTY[1], EMPTY[0],
        resident=True, seg=rows, req=req, spec=spec, base=k * rows,
        shard=(rows, k * rows, n - rows)) for k in range(d)])
    return tail_merge(part, alpha=req.alpha)[0]


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_tail_merge_equals_the_unsharded_tail(d, alpha):
    """The shards' records merged give the tail over all rows, every
    field, and the numpy model of the reference's chain; over random class
    tables with forced cross-tier ties on 13 nodes padded to D."""
    spec = SPECS["rtx4090"]
    for seed in range(4):
        rows = -(-13 // d) * d
        ns, v, _ = random_state(spec, 13, seed)
        ns = padded(ns, rows, 2)
        v = padded(v, rows)
        cls = random_cls(ns, seed, 6)
        req = FusedRequest(1000, 2, 2, 1, alpha)
        want = fused_argmax_plain(_t(cls), _t(ns), _t(v), *EMPTY, EMPTY[0],
                                  resident=True, seg=rows, req=req,
                                  spec=spec)[0]
        got = sharded_tail(cls, ns, v, d, req, spec)
        assert torch.equal(got, want), (seed, got, want)
        assert tuple(got[:7].tolist()) == model_winner(cls, alpha)


def test_tail_merge_same_tier_test_is_global():
    """Shard 0's survivors are all tier 0 at one f32 score (priority sums
    2^25 and 3 * 2^23, both 0.5 at alpha 0.5) and shard 1 holds a tier-1
    survivor at the same score (a priority sum of 2).  Shard 0 alone would
    refine by priority sum and pick its k = 2 entry; the global chain
    does not (two tiers at the top), so the k = 1 entry wins.  Merging
    finished winners would give the wrong answer; the monoid does not."""
    spec = SPECS["rtx4090"]
    ns, v, _ = random_state(spec, 4, 0)
    cls = np.zeros((CLS_FIELDS, 4), np.int32)
    cls[C_NID] = ns[2]
    cls[C_ANY, 0], cls[C_PP, 0], cls[C_K, 0] = 1, 2**25, 1
    cls[C_ANY, 1], cls[C_PP, 1], cls[C_K, 1] = 1, 3 * 2**23, 2
    cls[C_ANY + 1, 2], cls[C_PP + 1, 2], cls[C_K, 2] = 1, 2, 3
    req = FusedRequest(1000, 2, 2, 1, 0.5)
    got = sharded_tail(cls, ns, v, 2, req, spec)
    assert tuple(got[:3].tolist()) == (1, 0, 0)
    assert tuple(got[:7].tolist()) == model_winner(cls, 0.5)
    alone = model_winner(cls[:, :2], 0.5)
    assert alone[1] == 1                   # shard 0 alone refines by pp
    want = fused_argmax_plain(_t(cls), _t(ns), _t(v), *EMPTY, EMPTY[0],
                              resident=True, seg=4, req=req, spec=spec)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [2, 4])
def test_chunked_segments_merge(d):
    """Gathered rows in segments of 4 (the wide chunks' form), each shard
    sweeping the rows it holds: equal to the unsharded segments' winners,
    sentinel pads and rows of every shard among them."""
    spec = SPECS["rtx4090"]
    ns, v, dr = random_state(spec, 12, 5)
    rows = 12 // d
    gidx = np.array([3, 11, 0, IDX_SENTINEL, 7, 5, 1, 9, 2, IDX_SENTINEL,
                     10, 6], np.int32)
    req = FusedRequest(1000, 2, 2, 1, 0.5)
    kw = dict(m_res=8, resident=False, m_gather=8, req=req, spec=spec)
    from repro_torch.kernels.fused_class import fused_class_plain
    cls = fused_class_plain(_t(ns), _t(v), _t(dr), *EMPTY, _t(gidx), **kw)
    want = fused_argmax_plain(cls, _t(ns), _t(v), *EMPTY, _t(gidx),
                              resident=False, seg=4, req=req, spec=spec)
    shards = cp._shards_of(cp.cluster_mesh(mesh(d)), ns, v, dr)
    got = pd._sweep_tail(shards, [EMPTY[0]] * d, [EMPTY[1]] * d,
                         [_t(gidx)] * d, req, spec, m_res=8, resident=False,
                         m_gather=8, seg=4)
    assert rows * d == 12 and torch.equal(got, want)


# ---------------------------------------------------------------------------------
# The normal cycle and the shortlist across shards
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("d", MESHES)
def test_normal_shard_merge_equals_the_normal_cycle(d):
    """Each shard's K2 records (with patch rows of several shards, global
    ids) merged give the normal cycle over all rows, for every Table 3
    request size; an all-busy state gives row 0's outcome."""
    spec = SPECS["rtx4090"]
    for seed in range(3):
        ns, v, dr = random_state(spec, 13, seed)
        if seed == 2:
            ns[:2] = 0                              # no free GPU anywhere
        n = -(-13 // d) * d
        ns, v, dr = padded(ns, n, 2), padded(v, n), padded(dr, n)
        pidx = np.array([1, 6, 12], np.int32)
        pns, pv, pdr = random_state(spec, 3, 100 + seed)
        pns[2] = pidx
        pbuf = np.concatenate([pns.T, pv.transpose(1, 0, 2).reshape(3, -1),
                               pdr.T], axis=1)
        rows = n // d
        for wl in table3_workloads():
            req = FusedRequest(wl.priority, wl.gpus_per_instance,
                               wl.coregroups_per_instance(
                                   spec.coregroup_size),
                               0, 0.5)
            want = normal_cycle_plain(_t(ns), _t(v), _t(dr), _t(pidx),
                                      _t(pbuf), req, spec)
            recs = []
            for k in range(d):
                mine = (pidx >= k * rows) & (pidx < (k + 1) * rows)
                cols = slice(k * rows, (k + 1) * rows)
                recs.append(normal_cycle_part(
                    _t(ns[:, cols]), _t(v[:, cols]), _t(dr[:, cols]),
                    _t(pidx[mine]), _t(pbuf[mine]), req=req, spec=spec,
                    base=k * rows))
            got = normal_merge(torch.stack(recs), n=n, req=req, spec=spec)
            assert torch.equal(got, want), (seed, wl.name, got, want)


@pytest.mark.parametrize("d", MESHES)
@pytest.mark.parametrize("k", [1, 3, 16])
def test_shortlist_union_equals_the_prescreen(d, k):
    """Each shard's top min(K, rows) keys (global rows) merged by the
    union give the prescreen over all rows: ``gidx`` in order and the
    bits of ``excl_ub``; forced rows on several shards, tie-heavy
    bounds."""
    spec = SPECS["rtx4090"]
    for seed in range(3):
        ns, v, _ = random_state(spec, 16, seed)
        n = -(-16 // d) * d
        ns, v = padded(ns, n, 2), padded(v, n)
        rep = (np.random.default_rng(seed).random(n) < 0.6).astype(np.int32)
        rep[16:] = 0
        forced = np.array([2, 9, 15, IDX_SENTINEL], np.int32)
        req = FusedRequest(500, 1, 1, 1, 0.5)
        kk = min(k, n)
        want = prescreen_plain(_t(ns), _t(v), *EMPTY, _t(rep), _t(forced),
                               k=kk, req=req, spec=spec)
        rows = n // d
        kd = min(kk, rows)
        keys = torch.zeros((d, kd), dtype=torch.int64)
        outs = torch.zeros((d, kd + 1), dtype=torch.int32)
        for s in range(d):
            cols = slice(s * rows, (s + 1) * rows)
            prescreen(_t(ns[:, cols]), _t(v[:, cols]), *EMPTY,
                      _t(rep[cols]), _t(forced), k=kd, req=req, spec=spec,
                      out=outs[s], base=s * rows, sel=keys[s])
        got = prescreen_select(keys, k=kk, excl=outs[:, kd])
        assert torch.equal(got, want), (seed, got, want)


# ---------------------------------------------------------------------------------
# Decisions against the reference's host imp
# ---------------------------------------------------------------------------------

def ref_random_cluster(seed: int, nodes: int = 5) -> RefCluster:
    """``tests/test_fused_sourcing.py:random_cluster`` of the reference."""
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
                continue
            mask = sum(1 << x for x in g)
            cluster.bind(wl, node, RefPlacement(mask, mask, 0))
    return cluster


def full_key(dec):
    return decision_key(dec) + (
        None if dec.placement is None else
        (dec.placement.gpu_mask, dec.placement.cg_mask),
        dec.num_candidates)


def sequence(sched, wls, seed: int) -> list:
    """The reference's randomized parity sequence
    (``tests/test_distributed.py``): 8 plans with commits and rollbacks,
    then a 4-request ``plan_batch``."""
    ops = random.Random(seed)
    out = []
    for _ in range(8):
        txn = sched.plan(wls[ops.choice("BCD")], allow_normal=True)
        out.append(full_key(txn.decision))
        if txn.decision.kind != "reject":
            r = ops.random()
            if r < 0.5:
                txn.commit()
            elif r < 0.75:
                txn.commit()
                txn.rollback()
    out.extend(full_key(t.decision) for t in sched.plan_batch(
        [wls[ops.choice("BC")] for _ in range(4)]))
    return out


def port_of(ref: RefCluster) -> Cluster:
    return Cluster.from_instances(SPECS[ref.spec.name], ref.num_nodes,
                                  instance_rows(ref), device="cpu")


@pytest.mark.parametrize("d", MESHES)
def test_sharded_engine_decision_parity_randomized(d):
    """``imp_sharded`` (no shortlist at these sizes) and
    ``imp_sharded_full`` over D shards decide as the reference's host
    ``imp`` over its randomized sequences, candidate counts included; a
    shortlist of 4 rows decides the same (its counts are the
    shortlist's)."""
    rng = random.Random(7 + d)
    for _ in range(2):
        seed = rng.randrange(10_000)
        nodes = rng.choice((5, 11, 13))
        want = sequence(RefScheduler(ref_random_cluster(seed, nodes),
                                     engine="imp"), REF_WL3, seed)
        for engine, k in (("imp_sharded", 128), ("imp_sharded_full", 128),
                          ("imp_sharded", 4)):
            port = port_of(ref_random_cluster(seed, nodes))
            dcs = port.device_state(mesh=mesh(d))
            sched = TopoScheduler(port, engine=engine, shortlist_k=k)
            got = sequence(sched, WL3, seed)
            assert port.device_state() is dcs
            if k == 4:
                got, want_k = [g[:-1] for g in got], [w[:-1] for w in want]
            else:
                want_k = want
            assert got == want_k, (engine, d, seed, nodes)


def _big_pair(case: str):
    from test_torch_fused import (PORT_BIG, REF_BIG, RefTopoPolicy,
                                  RefWorkloadSpec, _overflow, _truncated,
                                  _wide)
    build = {"wide": _wide, "overflow": _overflow,
             "truncated": _truncated}[case]
    ref = build(RefCluster, RefPlacement, REF_BIG, REF_WL3, RefWorkloadSpec,
                RefTopoPolicy)
    return ref, Cluster.from_instances(PORT_BIG, ref.num_nodes,
                                       instance_rows(ref), device="cpu")


@pytest.mark.parametrize("case", ["wide", "overflow", "truncated"])
def test_sharded_wide_overflow_and_truncated_rows(case):
    """Wide rows in 16-slot chunks gathered from their owners, host
    fallback rows, truncated rows on the resident sweep: decisions equal
    the reference's host ``imp`` over 2 shards."""
    from repro.core.workload import WorkloadSpec as RefWorkloadSpec
    from repro_torch.core import WorkloadSpec as PortWorkloadSpec

    preemptor, ref_preemptor = WL3["B"], REF_WL3["B"]
    if case == "truncated":
        preemptor = PortWorkloadSpec("mid", priority=300, gpus_per_instance=1,
                                     cores_per_instance=8, preemptible=False)
        ref_preemptor = RefWorkloadSpec("mid", priority=300,
                                        gpus_per_instance=1,
                                        cores_per_instance=8,
                                        preemptible=False)
    ref, port = _big_pair(case)
    port.device_state(mesh=mesh(2))
    for allow_normal in (False, True):
        want = full_key(RefScheduler(ref, engine="imp").plan(
            ref_preemptor, allow_normal=allow_normal).decision)
        got = full_key(TopoScheduler(port, engine="imp_sharded").plan(
            preemptor, allow_normal=allow_normal).decision)
        assert got == want, (case, allow_normal)


@pytest.mark.parametrize("d", [3, 4])
def test_sharded_delta_encode_reads_rows_from_their_owners(d):
    """A plan's patch buffer staged over a sharded state (each shard's run
    of the sorted patch index, its dense rows rebuilt by the encoder from
    its own rows) equals, run after run, the unsharded state's buffer and
    host ``encode_row``'s rows."""
    from repro_torch.core.cluster import (ClusterView, ViewDelta,
                                          encode_row, flatten_rows,
                                          pack_rows)

    port = port_of(ref_random_cluster(5, 11))
    dcs = port.device_state(mesh=mesh(d)).sync()
    sched = TopoScheduler(port, engine="imp_sharded")
    view = ClusterView(port)
    for wl in (WL3["B"], WL3["C"], WL3["B"]):
        sched.plan(wl, view=view, allow_normal=False)
    vd = ViewDelta(view, dcs.mirror, dcs.pending)
    encoded = pd.PATH_COUNTS["encoded"]
    st = pd._stage(dcs, vd, pending=False)
    runs = [int(np.sum((st.pidx_host >= s.base)
                       & (st.pidx_host < s.base + s.rows)))
            for s in dcs.shards]
    assert [len(x) for x in st.pidx] == runs[:-1] + [
        runs[-1] + int(np.sum(st.pidx_host == IDX_SENTINEL))]
    assert pd.PATH_COUNTS["encoded"] - encoded == sum(
        1 for s in dcs.shards if np.any((vd.dense >= s.base)
                                        & (vd.dense < s.base + s.rows)))
    got = torch.cat(st.pbuf)
    flat = pd._stage(DeviceClusterState(port).sync(), vd, pending=False)
    assert torch.equal(got, flat.pbuf) and len(vd.dense)
    assert np.array_equal(torch.cat(st.pidx).numpy(), flat.pidx.numpy())
    nodes = [int(n) for n in st.pidx_host if n != IDX_SENTINEL]
    assert np.array_equal(got[:len(nodes)].numpy(), flatten_rows(*pack_rows(
        [encode_row(view, n, dcs.cap) for n in nodes], nodes, dcs.cap)))


def test_auto_routes_to_imp_sharded_at_the_threshold():
    """``TopoScheduler(engine="auto")`` at or above ``auto_threshold``
    resolves to ``imp_sharded`` over the default mesh (the CPU for a CPU
    cluster) and decides as the reference's host ``imp``."""
    ref = ref_random_cluster(11, 13)
    port = port_of(ref_random_cluster(11, 13))
    sched = TopoScheduler(port, engine="auto", auto_threshold=13)
    assert sched.engine == "imp_sharded"
    assert sequence(sched, WL3, 11) == sequence(
        RefScheduler(ref, engine="imp"), REF_WL3, 11)
    dcs = port.device_state()
    assert isinstance(dcs, cp.ShardedDeviceClusterState)
    assert dcs.mesh == cp.Mesh((torch.device("cpu"),))


def test_sharded_day_segment_matches_reference():
    """The reference's 12-node, 5-hour, seed-5 segment under
    ``imp_sharded`` with D = 4: every hour row equal to the reference's
    host ``imp`` day."""
    cfg = ColocationConfig(num_nodes=12, seed=5, engine="imp_sharded",
                           horizon_hours=5.0, device="cpu")
    sim = ColocationSim(cfg, policies=default_policies(cfg))
    sim.cluster.device_state(mesh=mesh(4))
    got = sim.run().key_metrics()
    want = ref_coloc.run_day_cycle(ref_coloc.ColocationConfig(
        num_nodes=12, seed=5, engine="imp", horizon_hours=5.0)).key_metrics()
    assert got["hours"] == want["hours"] and len(got["hours"]) == 5
    assert {k: v for k, v in got.items() if k != "engine"} == {
        k: v for k, v in want.items() if k != "engine"}
    assert sum(sim.sched.plan_counts.values()) > 0    # fused plans ran


# ---------------------------------------------------------------------------------
# The distributed functions
# ---------------------------------------------------------------------------------

SOURCE_CASES = ((4, 4, True), (2, 2, False), (1, 1, True))


def source_inputs(seed: int):
    ng, nc, bundle = SOURCE_CASES[seed]
    return cp.distributed_source_inputs(SPECS["rtx4090"], 37, 8, 2,
                                        Request(ng, nc, bundle),
                                        rng=np.random.default_rng(seed))


@functools.lru_cache(maxsize=None)
def ref_source(seed: int):
    """The reference's unsharded ``_source_best`` on `source_inputs`, run
    eagerly (once for every shard count)."""
    ng, nc, bundle = SOURCE_CASES[seed]
    consts = spec_constants(REF_SPECS["rtx4090"])
    with jax.disable_jit():
        ref = ref_source_best(
            *[jnp.asarray(a) for a in source_inputs(seed)],
            jnp.asarray(consts["numa_gpu_masks"]),
            jnp.asarray(consts["numa_cg_masks"]),
            jnp.asarray(consts["sock_onehot"]),
            request=RefRequest(ng, nc, bundle), alpha=0.5)
    return (int(np.asarray(ref[0], np.float32).view(np.int32)), int(ref[1]),
            int(ref[2]))


@pytest.mark.parametrize("d", [1, 3, 8])
def test_make_distributed_source_matches_reference(d):
    """The per-size sourcing over D shards (K3 a shard, first-index argmax
    merge): the reference's unsharded ``_source_best`` run eagerly, score
    bit for bit, node and combo equal, ties toward the first index."""
    for seed, (ng, nc, bundle) in enumerate(SOURCE_CASES):
        fn = cp.make_distributed_source(mesh(d), SPECS["rtx4090"],
                                        Request(ng, nc, bundle), alpha=0.5)
        score, node, combo = fn(*source_inputs(seed))
        assert (int(np.float32(score).view(np.int32)), int(node),
                int(combo)) == ref_source(seed)


FUSED_CASES = ((4, 4, True), (1, 1, False))


def fused_inputs(ng: int):
    """State tensors of 29 nodes, 4 victim slots, with free GPUs and
    CoreGroups above the victims' (one node's masks disjoint)."""
    ns, v, dr, thresh = cp.distributed_fused_inputs(
        SPECS["rtx4090"], 29, 4, rng=np.random.default_rng(ng))
    free = np.random.default_rng(3).integers(0, 16, (2, 29)) << 4
    ns[:2] = free
    dr |= free.astype(np.int32)
    return ns, v, dr, thresh


@functools.lru_cache(maxsize=None)
def ref_fused(case: int):
    """The reference's unsharded ``_sorting_winner`` and
    ``normal_cycle_core`` on `fused_inputs`, run eagerly (once for every
    shard count)."""
    ng, nc, bundle = FUSED_CASES[case]
    cpb = RefRequest(ng, nc, bundle).cgs_per_bundle
    ns, v, dr, thresh = fused_inputs(ng)
    ref_spec = REF_SPECS["rtx4090"]
    with jax.disable_jit():
        win = ref_sorting_winner(
            jnp.asarray(ns), jnp.asarray(v), jnp.asarray(dr),
            jnp.zeros(0, jnp.int32), jnp.int32(thresh), jnp.int32(ng),
            jnp.int32(nc), jnp.int32(cpb), jnp.float32(0.5), spec=ref_spec,
            m=4, g=0)
        normal = ref_normal_cycle(jnp.asarray(ns), jnp.int32(ng),
                                  jnp.int32(nc), jnp.int32(cpb),
                                  spec=ref_spec)
    return np.asarray(win).tolist(), np.asarray(normal).tolist()


@pytest.mark.parametrize("d", [1, 3, 8])
def test_make_distributed_fused_source_and_normal_cycle(d):
    """The fused sourcing and the normal cycle over D shards against the
    reference's unsharded ``_sorting_winner`` and ``normal_cycle_core``,
    run eagerly."""
    spec = SPECS["rtx4090"]
    for case, (ng, nc, bundle) in enumerate(FUSED_CASES):
        req = Request(ng, nc, bundle)
        ns, v, dr, thresh = fused_inputs(ng)
        got = cp.make_distributed_fused_source(mesh(d), spec, req, 0.5,
                                               m=4)(ns, v, dr, thresh)
        normal = cp.make_distributed_normal_cycle(mesh(d), spec, req)(ns)
        assert (got.tolist(), normal.tolist()) == ref_fused(case)


def test_mesh_devices_must_match_the_cluster():
    """A mesh holds the cluster's kind of device: CUDA devices for a CPU
    cluster are refused rather than run elsewhere."""
    cluster = Cluster(SPECS["rtx4090"], 3, device="cpu")
    with pytest.raises(ValueError, match="mesh device"):
        cluster.device_state(mesh=("meta",))
    assert cp.cluster_mesh(device="cpu") == cp.Mesh((torch.device("cpu"),))
    with pytest.raises(ValueError, match="at least one"):
        cp.as_mesh((), "cpu")
