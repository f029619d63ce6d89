"""The port's top-k MoE (`repro_torch.models.ffn`) against the JAX
reference's, on the CPU, in f32.

The routing is held exactly: the experts each token picks (ties to the
lower index, as ``lax.top_k``), the stable sort of the (token, expert)
slots, the keep mask and each slot's place in the capacity buffer
(``e_safe``/``pos_safe``, the dummy row E at C - 1 for a dropped slot).
The reference does not return its routing, so the test's oracle runs the
reference's own lines (``repro/models/ffn.py:117-134``) on the same input.
Outputs, the load-balance loss and the dropped fraction are held to the
reference's ``_moe_tokens``/``moe_apply`` at 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import ffn as ref_ffn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import MoEConfig, ffn  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(arch, **moe):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32)
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               compute_dtype=jnp.float32)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        rcfg = dataclasses.replace(rcfg,
                                   moe=dataclasses.replace(rcfg.moe, **moe))
    return cfg, rcfg


def _params(rcfg, seed=0, router=None):
    p = jax.tree.map(np.asarray, ref_ffn.moe_init(jax.random.PRNGKey(seed),
                                                  rcfg))
    if router is not None:
        p["router"] = router(np.array(p["router"]))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _ref_route(p, rcfg, xf):
    """The reference's routing lines, on [T, d] tokens."""
    T = xf.shape[0]
    E, k = rcfg.moe.num_experts, rcfg.moe.top_k
    C = ref_ffn.moe_capacity(rcfg, T)
    logits = jnp.einsum("TD,DE->TE", xf.astype(jnp.float32),
                        jnp.asarray(p["router"], jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=E)
    excl = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(T * k, dtype=jnp.int32) - excl[sorted_e]
    keep = pos_in_e < C
    return {"gate_vals": gate_vals, "expert_idx": expert_idx, "order": order,
            "keep": keep, "e_safe": jnp.where(keep, sorted_e, E),
            "pos_safe": jnp.where(keep, pos_in_e, C - 1), "capacity": C}


def _tied(r):
    """Router columns in equal pairs: every token's probabilities tie."""
    r[:, 1::2] = r[:, 0::2]
    return r


CASES = {
    "mixtral": ("mixtral-8x7b", {}, None),
    "olmoe": ("olmoe-1b-7b", {}, None),
    "drops": ("olmoe-1b-7b", {"capacity_factor": 0.5}, None),
    "ties": ("mixtral-8x7b", {}, _tied),
    "all_tied": ("olmoe-1b-7b", {}, np.zeros_like),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_matches_reference(case):
    arch, moe, router = CASES[case]
    cfg, rcfg = _configs(arch, **moe)
    p, tp = _params(rcfg, router=router)
    x = np.random.default_rng(1).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, cfg.d_model)
    want = _ref_route(p, rcfg, jnp.asarray(xf))
    got = ffn.moe_route(tp, cfg, torch.from_numpy(xf))
    assert got["capacity"] == want["capacity"]
    for key in ("expert_idx", "order", "keep", "e_safe", "pos_safe"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=f"{case}: {key}")
    np.testing.assert_allclose(got["gate_vals"].numpy(),
                               np.asarray(want["gate_vals"]), **TOL)
    kept = got["keep"].float().mean().item()
    if case in ("drops", "all_tied"):
        assert kept < 1.0, f"{case}: the case must drop slots"
    if case == "all_tied":                 # lax.top_k: the lowest indices
        assert (got["expert_idx"] == torch.arange(cfg.moe.top_k)).all()


@pytest.mark.parametrize("case", list(CASES))
def test_moe_tokens_match_reference(case):
    """Outputs and aux of ``_moe_tokens``, f32, at 1e-4."""
    arch, moe, router = CASES[case]
    cfg, rcfg = _configs(arch, **moe)
    p, tp = _params(rcfg, seed=2, router=router)
    x = np.random.default_rng(3).standard_normal(
        (3, 24, cfg.d_model)).astype(np.float32)
    want, waux = ref_ffn._moe_tokens(p, rcfg, jnp.asarray(x))
    got, aux = ffn._moe_tokens(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("load_balance_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(aux[key]), float(waux[key]), **TOL,
                                   err_msg=key)


@pytest.mark.parametrize("dispatch", ["global", "per_sequence", "shard_map"])
def test_moe_apply_dispatch_matches_reference(dispatch):
    """Each dispatch against the reference's ``moe_apply`` (per_sequence is
    its vmap over the batch; shard_map with no batch axes set is the
    global dispatch)."""
    cfg, rcfg = _configs("olmoe-1b-7b", dispatch=dispatch,
                         capacity_factor=0.75)
    p, tp = _params(rcfg, seed=4)
    x = np.random.default_rng(5).standard_normal(
        (3, 20, cfg.d_model)).astype(np.float32)
    want, waux = ref_ffn.moe_apply(p, rcfg, jnp.asarray(x))
    got, aux = ffn.moe_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("load_balance_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(aux[key]), float(waux[key]), **TOL,
                                   err_msg=key)


def test_per_sequence_is_global_dispatch_of_each_row():
    """per_sequence over B rows equals the global dispatch of each row on
    its own (capacity from its S tokens), aux averaged; it differs from
    the global dispatch of all B * S tokens once capacity drops."""
    cfg, _ = _configs("olmoe-1b-7b", dispatch="per_sequence",
                      capacity_factor=0.5)
    glob = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="global"))
    _, tp = _params(_configs("olmoe-1b-7b")[1], seed=6)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, 16, cfg.d_model)).astype(np.float32))
    got, aux = ffn.moe_apply(tp, cfg, x)
    rows = [ffn.moe_apply(tp, glob, x[b:b + 1]) for b in range(3)]
    torch.testing.assert_close(got, torch.cat([r[0] for r in rows]))
    torch.testing.assert_close(
        aux["dropped_fraction"],
        torch.stack([r[1]["dropped_fraction"] for r in rows]).mean())
    together, _ = ffn.moe_apply(tp, glob, x)
    assert not torch.allclose(together, got), "capacity drops differ"


def test_capacity_matches_reference():
    _, rcfg = _configs("mixtral-8x7b")
    cfg, _ = _configs("mixtral-8x7b")
    for t in (1, 4, 7, 48, 1000, 4096):
        assert ffn.moe_capacity(cfg, t) == ref_ffn.moe_capacity(rcfg, t)


def test_moe_init_router_in_f32():
    """The port's own init: the router f32 (the reference routes in f32),
    the experts in the compute dtype, the reference's shapes."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    p = ffn.moe_init(torch.Generator().manual_seed(0), cfg)
    ref = ref_ffn.moe_init(jax.random.PRNGKey(0),
                           ref_get_config("olmoe-1b-7b", smoke=True))
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == cfg.compute_dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


def test_moe_config_is_the_reference_field_set():
    import repro.models.common as ref_common

    assert [f.name for f in dataclasses.fields(MoEConfig)] == \
        [f.name for f in dataclasses.fields(ref_common.MoEConfig)]
