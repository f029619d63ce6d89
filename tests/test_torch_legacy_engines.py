"""The per-size engines of the port, ``imp_jax`` and ``imp_batched_legacy``,
on the CPU (K3's plain version).

* The reference's ``PARITY_ENGINES`` cases (``tests/test_fused_sourcing.py``:
  single plans over seeds and Table 3 classes, the alpha sweep, ``plan_batch``
  against one view, plan-batch-commit rounds): the port's ``imp_jax`` and
  ``imp_batched_legacy`` decide as the reference's host ``imp`` and its
  ``imp_batched_legacy`` (node, victims, tier, hit, masks, candidate count).
* ``evaluate_subsets`` against the reference's ``_evaluate_subsets_core``
  with padding slots whose masks are 0: a subset that takes one is tier 3,
  where K3 alone would score it as the smaller subset.
* The registry lists the reference's engines.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.engines import \
    registered_engines as ref_registered  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.preemption_jax import Request as RefRequest  # noqa: E402
from repro.core.preemption_jax import \
    _evaluate_subsets_core as ref_evaluate  # noqa: E402
from repro.core.preemption_jax import combo_table as ref_combo_table  # noqa: E402
from repro.core.preemption_jax import spec_constants  # noqa: E402
from repro.core.topology import RTX4090_SERVER as REF_RTX  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro_torch.core import (Cluster, TopoScheduler,  # noqa: E402
                              instance_rows, registered_engines,
                              table3_workloads)
from repro_torch.core.preemption_device import (Request,  # noqa: E402
                                                combo_table,
                                                evaluate_subsets)
from repro_torch.core.simulator import decision_key  # noqa: E402
from repro_torch.core.topology import RTX4090_SERVER  # noqa: E402
from repro_torch.kernels import topo_score as ts  # noqa: E402

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}
REF_ENGINES = ("imp", "imp_batched_legacy")
PORT_ENGINES = ("imp_jax", "imp_batched_legacy")


def ref_random_cluster(seed: int, nodes: int = 5) -> RefCluster:
    """``tests/test_fused_sourcing.py:random_cluster`` of the reference."""
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
                continue  # leave a hole
            mask = sum(1 << x for x in g)
            cluster.bind(wl, node, RefPlacement(mask, mask, 0))
    return cluster


def port_of(ref: RefCluster) -> Cluster:
    return Cluster.from_instances(RTX4090_SERVER, ref.num_nodes,
                                  instance_rows(ref), device="cpu")


def full_key(dec):
    return decision_key(dec) + (
        None if dec.placement is None else
        (dec.placement.gpu_mask, dec.placement.cg_mask),
        dec.num_candidates)


def keys_of(run, seed: int, nodes: int = 5, **kw) -> dict:
    """``run(sched, wls)``'s keys for every engine of both packages on
    the same random cluster."""
    out = {}
    for engine in REF_ENGINES:
        out["ref:" + engine] = run(RefScheduler(
            ref_random_cluster(seed, nodes), engine=engine, **kw), REF_WL3)
    for engine in PORT_ENGINES:
        out[engine] = run(TopoScheduler(
            port_of(ref_random_cluster(seed, nodes)), engine=engine, **kw),
            WL3)
    return out


def same(keys: dict) -> bool:
    return len({repr(v) for v in keys.values()}) == 1


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 42, 1234])
@pytest.mark.parametrize("wl_name", ["A", "B", "C"])
def test_legacy_engines_match_host_imp(seed, wl_name):
    """The per-size engines' candidates give select_best's winner: same
    node, victims, tier, masks and candidate count as every exact engine
    (``test_fused_matches_legacy_and_python``)."""
    keys = keys_of(lambda s, w: full_key(s.plan(
        w[wl_name], allow_normal=False).decision), seed)
    assert same(keys), keys


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_legacy_engines_across_alpha(alpha):
    for seed in (1, 9, 77):
        keys = keys_of(lambda s, w: full_key(s.plan(
            w["B"], allow_normal=False).decision), seed, alpha=alpha)
        assert same(keys), (seed, alpha, keys)


def test_legacy_engines_in_plan_batch():
    """Later plans of a batch see the earlier ones' planned evictions
    through the copy-on-write view."""
    batch = ("B", "B", "C", "B")
    keys = keys_of(lambda s, w: [full_key(t.decision) for t in s.plan_batch(
        [w[n] for n in batch])], 21, nodes=4)
    assert same(keys), keys


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_legacy_engines_plan_batch_across_alpha(alpha):
    batch = ("B", "B", "C", "B", "C", "C", "B", "D")
    for seed in (3, 42):
        keys = keys_of(lambda s, w: [full_key(t.decision) for t in
                                     s.plan_batch([w[n] for n in batch])],
                       seed, alpha=alpha)
        assert same(keys), (seed, alpha, keys)


def test_legacy_engines_across_commit_sequences():
    """plan_batch then commit-all rounds: the engines read the committed
    state each round."""
    def run(sched, w):
        seq = []
        for names in (("B", "C", "B"), ("C", "B"), ("B", "B", "C")):
            txns = sched.plan_batch([w[n] for n in names])
            for t in txns:
                t.commit()
            seq.extend(full_key(t.decision) for t in txns)
        return seq

    keys = keys_of(run, 17)
    assert same(keys), keys


@pytest.mark.parametrize("k", [1, 2, 3])
def test_padding_slots_are_infeasible(k):
    """Two victims and two padding slots (masks 0, ``valid`` False) on a
    node whose free masks already fit a 1-GPU request: every subset that
    takes a padding slot is tier 3 and scores -inf, as in the reference,
    though K3 alone gives it the tier of the smaller subset."""
    spec = RTX4090_SERVER
    free_gpu, free_cg = np.int32(0b1), np.int32(0b1)
    vg = np.array([0b10, 0b100, 0, 0], np.int32)
    vc = np.array([0b10, 0b100, 0, 0], np.int32)
    vp = np.array([100, 200, 0, 0], np.int32)
    valid = np.array([True, True, False, False])
    table = combo_table(4, k)
    tier, prio, ok, score = evaluate_subsets(
        *(torch.from_numpy(np.asarray(x)) for x in (free_gpu, free_cg, vg,
                                                    vc, vp, valid, table)),
        spec=spec, request=Request(1, 1, True), alpha=0.5)
    consts = spec_constants(REF_RTX)
    want = ref_evaluate(
        *(jnp.asarray(x) for x in (free_gpu, free_cg, vg, vc, vp, valid,
                                   ref_combo_table(4, k))),
        consts["numa_gpu_masks"], consts["numa_cg_masks"],
        consts["sock_onehot"], request=RefRequest(1, 1, True))
    assert tier.tolist() == np.asarray(want[0]).tolist()
    assert prio.tolist() == np.asarray(want[1]).tolist()
    assert ok.tolist() == np.asarray(want[2]).tolist()
    pads = table.max(axis=1) >= 2
    assert pads.any() and (tier[torch.from_numpy(pads)] == 3).all()
    assert (score[torch.from_numpy(pads)] == -np.inf).all()
    # the trap: K3 over the same freed masks, unmasked, finds them feasible
    freed_g = torch.from_numpy(free_gpu | np.bitwise_or.reduce(
        vg[table], axis=1))
    freed_c = torch.from_numpy(free_cg | np.bitwise_or.reduce(
        vc[table], axis=1))
    raw, _ = ts.topo_score(freed_g.to(torch.int32), freed_c.to(torch.int32),
                           prio, spec, ts.TopoRequest(1, 1, 1))
    assert (raw[torch.from_numpy(pads)] < 3).all()


def test_registry_lists_the_reference_engines():
    """``test_registry_contains_all_paper_engines``: every paper engine is
    registered, and the port's registry is the reference's."""
    names = registered_engines()
    for name in ("godel", "exhaustive", "imp", "imp_jax", "imp_batched",
                 "imp_pallas", "imp_batched_legacy", "imp_sharded",
                 "imp_sharded_full"):
        assert name in names
    assert set(names) == set(ref_registered())
