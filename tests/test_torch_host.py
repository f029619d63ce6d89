"""The port's host layer against the JAX package's: placement, FlexTopo and
the cluster state carried over with `Cluster.from_instances`.

Inputs come from numpy/random seeds and go to both packages; every port
object is built with ``device="cpu"``.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import placement as ref_placement  # noqa: E402
from repro.core.flextopo import FlexTopo as RefFlexTopo  # noqa: E402
from repro.core.simulator import SimConfig as RefSimConfig  # noqa: E402
from repro.core.simulator import \
    build_saturated_cluster as ref_build  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.cluster import Cluster, instance_rows  # noqa: E402
from repro_torch.core.flextopo import ALLOCATED, FlexTopo  # noqa: E402
from repro_torch.core.simulator import (SimConfig,  # noqa: E402
                                        build_saturated_cluster)
from repro_torch.core.topology import SPECS  # noqa: E402

SPEC_NAMES = sorted(SPECS)


def _requests(spec):
    """Every (need_gpus, need_cgs, bundle) a host engine may ask for."""
    out = []
    for g in range(0, spec.num_gpus + 1):
        for per in (1, 2):
            c = max(1, g * per)
            if c <= spec.num_coregroups:
                out.append((g, c, True))
                out.append((g, c, False))
    return out


@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_spec_masks_match(spec_name):
    spec, ref = SPECS[spec_name], REF_SPECS[spec_name]
    assert spec == spec.__class__(**{f: getattr(ref, f) for f in
                                     spec.__dataclass_fields__})
    for attr in ("numa_gpu_masks", "numa_cg_masks", "socket_gpu_masks",
                 "socket_cg_masks", "socket_of_numa_arr"):
        np.testing.assert_array_equal(getattr(spec, attr), getattr(ref, attr))


@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_placement_functions_match_reference(spec_name):
    """best_tier / place / place_blind / achieved_tier / is_topology_hit on
    seeded free masks, for every request shape."""
    spec, ref = SPECS[spec_name], REF_SPECS[spec_name]
    rng = np.random.default_rng(SPEC_NAMES.index(spec_name))
    fg = rng.integers(0, spec.all_gpu_mask + 1, 150)
    fc = rng.integers(0, spec.all_cg_mask + 1, 150)
    fg[:3] = (0, spec.all_gpu_mask, 1)
    fc[:3] = (0, spec.all_cg_mask, 1)
    for g_mask, c_mask in zip(fg.tolist(), fc.tolist()):
        assert placement.achieved_tier(spec, g_mask) == \
            ref_placement.achieved_tier(ref, g_mask)
        for ng, nc, bundle in _requests(spec):
            assert placement.best_tier(spec, g_mask, c_mask, ng, nc, bundle) \
                == ref_placement.best_tier(ref, g_mask, c_mask, ng, nc, bundle)
            got = placement.place(spec, g_mask, c_mask, ng, nc, bundle)
            want = ref_placement.place(ref, g_mask, c_mask, ng, nc, bundle)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.gpu_mask, got.cg_mask, got.tier) == \
                    (want.gpu_mask, want.cg_mask, want.tier)
                assert placement.is_topology_hit(
                    spec, got.gpu_mask, got.cg_mask, ng, nc, bundle) == \
                    ref_placement.is_topology_hit(
                        ref, want.gpu_mask, want.cg_mask, ng, nc, bundle)
            got = placement.place_blind(spec, g_mask, c_mask, ng, nc)
            want = ref_placement.place_blind(ref, g_mask, c_mask, ng, nc)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.gpu_mask, got.cg_mask, got.tier) == \
                    (want.gpu_mask, want.cg_mask, want.tier)
                assert placement.is_topology_hit(
                    spec, got.gpu_mask, got.cg_mask, ng, nc, bundle) == \
                    ref_placement.is_topology_hit(
                        ref, want.gpu_mask, want.cg_mask, ng, nc, bundle)


@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_flextopo_crd_matches_reference(spec_name):
    """The dict-held graph serializes exactly like the networkx one after
    the same allocate / release / failure sequence."""
    spec, ref = SPECS[spec_name], REF_SPECS[spec_name]
    ours, theirs = FlexTopo(spec, "node-3"), RefFlexTopo(ref, "node-3")
    rng = random.Random(7)
    held = []
    for step in range(40):
        m = ours.as_masks()
        free_g = [g for g in range(spec.num_gpus) if m.free_gpu_mask >> g & 1]
        free_c = [c for c in range(spec.num_coregroups)
                  if m.free_cg_mask >> c & 1]
        if held and (rng.random() < 0.35 or not free_g or not free_c):
            name = held.pop(rng.randrange(len(held)))
            ours.release(name)
            theirs.release(name)
        elif free_g and free_c:
            name = f"pod-{step}"
            gs = rng.sample(free_g, rng.randint(1, len(free_g)))
            cs = rng.sample(free_c, rng.randint(1, len(free_c)))
            ours.allocate(name, gs, cs)
            theirs.allocate(name, gs, cs)
            held.append(name)
        if step == 20 and free_g:
            ours.fail_gpu(free_g[0])
            theirs.fail_gpu(free_g[0])
        assert (ours.as_masks().free_gpu_mask, ours.as_masks().free_cg_mask) \
            == (theirs.as_masks().free_gpu_mask,
                theirs.as_masks().free_cg_mask)
        assert ours.to_crd() == theirs.to_crd()
        assert ours.used_by() == theirs.used_by()
    back = FlexTopo.from_crd(ours.to_crd(), spec)
    assert back.to_crd() == ours.to_crd()
    kinds = {}
    for _, _, data in ours.graph.edges(data=True):
        kinds[data["kind"]] = kinds.get(data["kind"], 0) + 1
    ref_kinds = {}
    for _, _, data in theirs.graph.edges(data=True):
        ref_kinds[data["kind"]] = ref_kinds.get(data["kind"], 0) + 1
    assert kinds == ref_kinds


def test_flextopo_graph_reads():
    t = FlexTopo(SPECS["rtx4090"])
    t.allocate("pod-a", gpus=[0], coregroups=[3])
    assert t.graph.nodes[("gpu", 0)]["used_by"] == "pod-a"
    assert t.graph.nodes[("core", 24)]["status"] == ALLOCATED
    assert len(list(t.graph.nodes())) == 2 + 8 + 8 + 64 + 8
    with pytest.raises(ValueError):
        t.allocate("pod-b", gpus=[0], coregroups=[])


@pytest.mark.parametrize("seed", [0, 1])
def test_saturated_cluster_matches_reference(seed):
    """``saturate`` draws from random.Random in the reference's order: the
    same seed builds the same instances, uid for uid."""
    ref = ref_build(RefSimConfig(num_nodes=20, seed=seed))
    ours = build_saturated_cluster(SimConfig(num_nodes=20, seed=seed,
                                             device="cpu"))
    assert instance_rows(ours) == instance_rows(ref)


def test_from_instances_carries_reference_state():
    """A reference cluster taken across through plain rows: the same free
    masks and the same victims (uids in order) on every node, and new uids
    continue past the largest one."""
    ref = ref_build(RefSimConfig(num_nodes=24, seed=3))
    # punch holes so uids are not contiguous
    for uid in sorted(ref.instances)[::9]:
        ref.evict(uid)
    ours = Cluster.from_instances(SPECS["rtx4090"], 24, instance_rows(ref),
                                  device="cpu")
    assert ours.device.type == "cpu"
    for node in range(24):
        assert ours.free_masks(node) == ref.free_masks(node)
        for prio in (200, 500, 1000, 1500):
            assert [v.uid for v in ours.victims_on(node, prio)] == \
                [v.uid for v in ref.victims_on(node, prio)]
    assert ours.count_by_workload() == ref.count_by_workload()
    nxt = ours.bind(ours.instances[max(ours.instances)].workload, 0,
                    placement.Placement(0, 0, 0))
    assert nxt.uid == max(ref.instances) + 1


def test_cuda_device_requires_cuda(monkeypatch):
    """Asking for the card where there is none raises instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Cluster(SPECS["rtx4090"], 2)
    with pytest.raises(RuntimeError):
        build_saturated_cluster(SimConfig(num_nodes=2))
    with pytest.raises(ValueError):
        Cluster(SPECS["rtx4090"], 2, device="meta")
