"""Public names of the ported modules, held against the reference's.

* ``run_plan_latency_experiment(..., warmup=)``, passed on to
  ``TopoScheduler(warmup=)``;
* ``core.preemption.brute_force_min_k``, the smallest feasible subset size
  by definition: the same ``(k, candidates)`` as the reference's;
* ``Cluster(..., node_index=)``: ``False`` is the naive scan, with the same
  answers and decisions;
* ``ServeEngine.run(requests, greedy=True)``: the same tokens;
* ``TopoScheduler(shortlist_mode="best_effort")`` on ``imp_batched``
  runs the shortlist (it was refused while the port had none).
"""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import Cluster as RefCluster  # noqa: E402
from repro.core import TopoScheduler as RefScheduler  # noqa: E402
from repro.core.placement import Placement as RefPlacement  # noqa: E402
from repro.core.preemption import \
    brute_force_min_k as ref_brute_force_min_k  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.simulator import \
    run_plan_latency_experiment as ref_plan_latency  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.core.workload import table3_workloads as ref_table3  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (Cluster, TopoScheduler,  # noqa: E402
                              instance_rows, table3_workloads)
from repro_torch.core.placement import Placement  # noqa: E402
from repro_torch.core.preemption import brute_force_min_k  # noqa: E402
from repro_torch.core.simulator import (SimConfig,  # noqa: E402
                                        decision_key,
                                        run_plan_latency_experiment)
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.models import build_model, load_reference_params  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

WL3 = {w.name: w for w in table3_workloads()}
REF_WL3 = {w.name: w for w in ref_table3()}


def _fill(cluster, placement, wls, seed: int) -> None:
    """Random 1- and 2-GPU Table 3 instances with holes, bound in the same
    order into either package's cluster."""
    rng = random.Random(seed)
    spec = cluster.spec
    for node in range(cluster.num_nodes):
        free = list(range(spec.num_gpus))
        rng.shuffle(free)
        cgs = spec.num_coregroups // spec.num_gpus
        while free:
            two = len(free) >= 2 and rng.random() < 0.4
            g = [free.pop(), free.pop()] if two else [free.pop()]
            if rng.random() < 0.2:
                continue
            cg = [c for x in g for c in range(x * cgs, x * cgs + cgs)]
            cluster.bind(wls["C" if two else "D"], node, placement(
                sum(1 << x for x in g), sum(1 << c for c in cg), 0))


@pytest.mark.parametrize("warmup", [False, True])
def test_plan_latency_experiment_takes_warmup(warmup):
    """``warmup`` reaches the scheduler (the fused engine's warm-up runs on
    the CPU's plain versions) and changes no decision: the counts equal
    the reference's host ``imp`` run with the same argument, and the
    decisions equal the port's ``imp`` run."""
    cfg = SimConfig(num_nodes=8, seed=1, device="cpu")
    got = run_plan_latency_experiment(cfg, "imp_batched", "B", samples=4,
                                      warmup=warmup)
    host = run_plan_latency_experiment(cfg, "imp", "B", samples=4,
                                       warmup=warmup)
    ref = ref_plan_latency(RefSimConfig(num_nodes=8, seed=1), "imp", "B",
                           samples=4, warmup=warmup)
    assert got.decision_keys == host.decision_keys
    assert ((got.preemptions, got.hits, got.failures, got.placements)
            == (ref.preemptions, ref.hits, ref.failures, ref.placements))
    assert len(got.sourcing_us) == len(ref.sourcing_us) == 4


@pytest.mark.parametrize("sku", ["rtx4090", "a100"])
@pytest.mark.parametrize("wl_name", ["A", "B", "C"])
def test_brute_force_min_k_matches_reference(sku, wl_name):
    """Every node of a random cluster: the same smallest k and the same
    feasible subsets (node, victims, tier, priority sum) as the
    reference's oracle, or None on both sides."""
    ref = RefCluster(REF_SPECS[sku], 5)
    _fill(ref, RefPlacement, REF_WL3, seed=len(sku) + ord(wl_name))
    port = Cluster.from_instances(SPECS[sku], 5, instance_rows(ref),
                                  device="cpu")
    seen = 0
    for node in range(5):
        want = ref_brute_force_min_k(ref, REF_WL3[wl_name], node)
        got = brute_force_min_k(port, WL3[wl_name], node)
        if want is None:
            assert got is None, node
            continue
        seen += 1
        assert got[0] == want[0], node
        assert ([dataclasses.astuple(c) for c in got[1]]
                == [(c.node, c.victims, c.tier, c.priority_sum)
                    for c in want[1]]), node
    assert seen


@pytest.mark.parametrize("seed", [0, 4])
def test_cluster_without_node_index_decides_the_same(seed):
    """``node_index=False`` scans every instance for ``instances_on`` and
    reads the free masks afresh; the answers, and the decisions of a
    commit sequence, equal the indexed cluster's and the reference's naive
    cluster's."""
    ref = RefCluster(REF_SPECS["rtx4090"], 6, node_index=False)
    naive = Cluster(SPECS["rtx4090"], 6, node_index=False, device="cpu")
    indexed = Cluster(SPECS["rtx4090"], 6, device="cpu")
    assert naive.node_index is False and indexed.node_index is True
    _fill(ref, RefPlacement, REF_WL3, seed)
    _fill(naive, Placement, WL3, seed)
    _fill(indexed, Placement, WL3, seed)
    for node in range(6):
        assert naive.free_masks(node) == indexed.free_masks(node)
        assert (sorted(i.uid for i in naive.instances_on(node))
                == sorted(i.uid for i in indexed.instances_on(node)))
    keys = {}
    for name, cluster, sched in (
            ("ref", ref, RefScheduler(ref, engine="imp")),
            ("naive", naive, TopoScheduler(naive, engine="imp")),
            ("indexed", indexed, TopoScheduler(indexed, engine="imp"))):
        wls = REF_WL3 if name == "ref" else WL3
        seq = []
        for wl_name in ("B", "C", "D", "B", "A"):
            txn = sched.plan(wls[wl_name])
            txn.commit()
            seq.append(decision_key(txn.decision))
        keys[name] = seq
    assert keys["naive"] == keys["indexed"] == keys["ref"]


def test_serve_engine_run_takes_greedy():
    """``run(requests, greedy=True)``: the tokens of ``run(requests)`` and of
    the reference's ``run(requests, greedy=True)`` (f32, smoke llama)."""
    rcfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                               compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    rapi = ref_build_model(rcfg)
    tree = rapi.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(5, 24, 3)]
    ref = RefServeEngine(rapi, tree, batch_size=2, seq_len=32).run(
        [RefRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)], greedy=True)
    params = load_reference_params(cfg, jax.tree.map(np.asarray, tree),
                                   device="cpu")
    api = build_model(cfg, device="cpu")
    got = [ServeEngine(api, params, batch_size=2, seq_len=32).run(
        [Request(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)], **kw) for kw in ({"greedy": True},
                                                          {})]
    assert ([r.output for r in got[0]] == [r.output for r in got[1]]
            == [r.output for r in ref])


def test_best_effort_shortlist_is_refused_on_imp_batched():
    """``"best_effort"`` on ``imp_batched`` (and ``auto``, which routes to
    it) is no longer refused: the shortlist runs, and with ``k`` below the
    node count its plans are exactly evaluated and commit; guaranteed mode
    decides as host imp with provenance 128 / ``"guaranteed"``; engines the
    reference gives no shortlist keep accepting the argument and ignore
    it."""
    ref = RefCluster(REF_SPECS["rtx4090"], 4)
    _fill(ref, RefPlacement, REF_WL3, seed=2)
    port = Cluster.from_instances(SPECS["rtx4090"], 4, instance_rows(ref),
                                  device="cpu")
    for engine in ("imp_batched", "auto"):
        sched = TopoScheduler(port, engine=engine, shortlist_k=2,
                              shortlist_mode="best_effort")
        assert sched.shortlist.mode == "best_effort"
        dec = sched.plan(WL3["B"], allow_normal=False).decision
        assert dec.kind == "preempted" and dec.placement is not None
        assert dec.sourcing_provenance["shortlist_mode"] == "best_effort"
    dec = TopoScheduler(port, engine="imp_batched").plan(WL3["B"]).decision
    assert dec.sourcing_provenance["shortlist_k"] == 128
    assert dec.sourcing_provenance["shortlist_mode"] == "guaranteed"
    assert decision_key(dec) == decision_key(
        RefScheduler(ref, engine="imp").plan(REF_WL3["B"]).decision)
    TopoScheduler(port, engine="imp_batched", shortlist_k=0,
                  shortlist_mode="best_effort")
    for engine in ("imp", "godel"):
        sched = TopoScheduler(port, engine=engine,
                              shortlist_mode="best_effort")
        assert sched.shortlist is None


# ---------------------------------------------------------------------------------
# model signatures as the reference has them
# ---------------------------------------------------------------------------------

def test_serve_engine_takes_donate_cache():
    """``ServeEngine(..., donate_cache=)`` as the reference's: accepted and
    without effect (the caches are updated in place either way), the same
    tokens for both values."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    api = build_model(cfg, device="cpu")
    params = api.init(3)
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(5, 12,
                                                          dtype=np.int32)]
    outs = [[r.output for r in ServeEngine(
        api, params, batch_size=2, seq_len=16, donate_cache=donate).run(
            [Request(rid=i, prompt=p, max_new_tokens=3)
             for i, p in enumerate(prompts)])] for donate in (True, False)]
    assert outs[0] == outs[1]


def test_init_cache_takes_dtype_by_position():
    """``init_cache(cfg, batch, capacity, dtype)``: the fourth argument is
    the dtype, as in the reference (``device`` is keyword-only); None
    keeps the compute dtype."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention

    cfg = get_config("llama3.2-1b", smoke=True)
    ref = ref_attn.init_cache(ref_get_config("llama3.2-1b", smoke=True), 2,
                              8, jnp.float32)
    got = attention.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    assert got["k"].dtype == got["v"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert attention.init_cache(cfg, 2, 8)["k"].dtype == cfg.compute_dtype
    assert (got["abs"] == -1).all() and got["abs"].dtype == torch.int32


@pytest.mark.parametrize("name", ["rmsnorm_init", "layernorm_init"])
def test_norm_inits_take_dtype(name):
    """``rmsnorm_init(d, dtype=f32)`` / ``layernorm_init(d, dtype=f32)`` as
    the reference's: the same keys, shapes and values, the dtype as given
    by position (``device`` is keyword-only)."""
    from repro.models import common as ref_common
    from repro_torch.models import common

    ref = getattr(ref_common, name)(24, jnp.bfloat16)
    got = getattr(common, name)(24, torch.bfloat16, device="cpu")
    assert sorted(got) == sorted(ref)
    for key, val in got.items():
        assert val.dtype == torch.bfloat16
        np.testing.assert_array_equal(val.float().numpy(),
                                      np.asarray(ref[key], np.float32))
    assert getattr(common, name)(24)["scale"].dtype == torch.float32


def test_mlp_init_takes_d_ff():
    """``mlp_init(gen, cfg, d_ff=)`` as the reference's ``mlp_init(key, cfg,
    d_ff=None)``: the shapes of the reference's at a given and the default
    width, for the gated and the plain MLP."""
    from repro.models import ffn as ref_ffn
    from repro_torch.models import ffn

    for arch in ("llama3.2-1b", "seamless-m4t-medium"):
        cfg = get_config(arch, smoke=True)
        rcfg = ref_get_config(arch, smoke=True)
        for d_ff in (None, 40):
            got = ffn.mlp_init(torch.Generator().manual_seed(0), cfg, d_ff)
            ref = ref_ffn.mlp_init(jax.random.PRNGKey(0), rcfg, d_ff)
            assert {k: tuple(v.shape) for k, v in got.items()} == {
                k: tuple(v.shape) for k, v in ref.items()}
