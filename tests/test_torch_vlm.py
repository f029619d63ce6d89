"""The port's VLM family (paligemma-3b: a patch-embedding prefix in front
of the text under the prefix-LM mask) against the JAX reference, weights
carried across, at its smoke size (8 patches) on the CPU.

The same numpy-seeded patch embeddings and tokens go through the
reference's prefill and 4 decode steps (at the absolute positions after the
prefix) and through the port's (K4's plain version with ``prefix_len`` on
these CPU tensors), with ``test_torch_encdec.py``'s rule.  Then decode
against a fresh prefill (the reference's ``test_serving.py`` protocol),
``ServeEngine``'s greedy tokens against the reference's engine (f32), and
the prefix-LM mask's receptive field.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import count_params as ref_count_params  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import cache_capacity, get_config  # noqa: E402
from repro_torch.models import (build_model, count_params,  # noqa: E402
                                load_reference_params, lm)
from test_torch_encdec import (_configs, _tree,  # noqa: E402
                               check_against_reference,
                               engine_matches_reference_engine, modality,
                               port_batch, spy_attention)
from test_torch_families import _leaves  # noqa: E402

ARCH = "paligemma-3b"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dtype):
    caches = check_against_reference(ARCH, dtype)
    cfg = get_config(ARCH, smoke=True)
    # the cache holds the prefix, then the text, then the decoded tokens
    assert caches[0]["abs"].tolist() == list(range(cfg.frontend_len + 44))


def test_weights_carried_across():
    """The reference's tree with its blocks unstacked: the tied embedding
    and no head, each leaf of the port's own init's dtype and shape."""
    cfg, rcfg = _configs(ARCH, "bf16")
    tree = _tree(rcfg, seed=1)
    params = load_reference_params(cfg, tree, device="cpu")
    own = build_model(cfg, device="cpu").init(0)
    assert count_params(params) == ref_count_params(tree) == count_params(own)
    assert "head" not in params and len(params["blocks"]) == cfg.n_layers
    got = {k: (v.dtype, v.shape) for k, v in _leaves(params)}
    assert got == {k: (v.dtype, v.shape) for k, v in _leaves(own)}
    assert sorted({k.rsplit("/", 1)[-1] for k, (dt, _) in got.items()
                   if dt == torch.float32}) == ["scale"]


def test_embed_tokens_matches_reference():
    """The text scaled by sqrt(d) in the compute dtype, then the prefix,
    unscaled, in front; bf16 as the reference rounds it."""
    cfg, rcfg = _configs(ARCH, "bf16")
    tree = _tree(rcfg, seed=2)
    params = load_reference_params(cfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 5),
                                             dtype=np.int32)
    prefix = modality(cfg, 2)["prefix_embeds"]
    want = ref_lm.embed_tokens(tree, rcfg, jnp.asarray(toks),
                               jnp.asarray(prefix))
    got = lm.embed_tokens(params, cfg, torch.from_numpy(toks),
                          torch.from_numpy(prefix))
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, cfg.frontend_len + 5, cfg.d_model)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _hidden(api, params, cfg, toks, prefix):
    """The last block's hidden states over prefix + text, f32."""
    x = lm.embed_tokens(params, cfg, torch.from_numpy(toks),
                        torch.from_numpy(prefix))
    pos = torch.arange(x.shape[1], dtype=torch.int32)[None]
    hidden, _ = lm._forward_blocks(params, cfg, x, pos, None,
                                   cfg.frontend_len)
    return hidden


def test_prefix_lm_receptive_field():
    """The first prefix position sees the last one (the bidirectional
    block), and a text position sees no later position."""
    cfg = _configs(ARCH, "f32")[0]
    api = build_model(cfg, device="cpu")
    params = api.init(3)
    P = cfg.frontend_len
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab, (1, 12), dtype=np.int32)
    prefix = modality(cfg, 1)["prefix_embeds"]
    base = _hidden(api, params, cfg, toks, prefix)
    moved = prefix.copy()
    moved[:, -1] += 1.0
    h = _hidden(api, params, cfg, toks, moved)
    assert not torch.allclose(h[:, 0], base[:, 0], atol=1e-3)
    later = toks.copy()
    later[:, 6:] = rng.integers(1, cfg.vocab, (1, 6))
    h = _hidden(api, params, cfg, later, prefix)
    torch.testing.assert_close(h[:, :P + 6], base[:, :P + 6], atol=0, rtol=0)
    assert not torch.allclose(h[:, P + 6], base[:, P + 6], atol=1e-3)


def test_every_prefill_attention_goes_through_the_kernel(monkeypatch):
    """Each layer's prefill attention runs through K4 with the prefix-LM
    mask over prefix + text, none through ``_gqa_attend``; a decode step
    runs one plain attention a layer."""
    cfg = get_config(ARCH, smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    calls = spy_attention(monkeypatch)
    P = cfg.frontend_len
    _, caches = api.prefill(
        params, port_batch(cfg, np.ones((2, 20), np.int32), modality(cfg, 2)),
        P + 21)
    assert calls["plain"] == 0
    assert calls["flash"] == [(True, P, P + 20, P + 20)] * cfg.n_layers
    calls["flash"].clear()
    api.decode_step(params, caches, torch.ones(2, dtype=torch.int64), P + 20)
    assert calls["flash"] == [] and calls["plain"] == cfg.n_layers


def test_decode_matches_prefill():
    """Token-by-token decode at the positions after the 8 patches
    reproduces a fresh prefill over the extended text with the same
    patches; bf16 compute, the reference test's tolerance."""
    cfg = get_config(ARCH, smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    rng = np.random.default_rng(42)
    b, s, t_new = 2, 24, 4
    P = cfg.frontend_len
    toks = rng.integers(1, cfg.vocab, (b, s + t_new), dtype=np.int32)
    mod = modality(cfg, b)
    cap = cache_capacity(cfg, P + s + t_new)
    logits, caches = api.prefill(params, port_batch(cfg, toks[:, :s], mod),
                                 cap)
    for t in range(s, s + t_new):
        ref_logits, _ = api.prefill(params,
                                    port_batch(cfg, toks[:, :t + 1], mod),
                                    cap)
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(toks[:, t]), P + t)
        np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                                   atol=0.08, rtol=0.08,
                                   err_msg=f"{ARCH} step {t}")


def test_engine_matches_reference_engine():
    """Zero patch embeddings in front of each prompt; the cache holds the
    prefix and the decode positions count it."""
    engine = engine_matches_reference_engine(ARCH)
    P = get_config(ARCH, smoke=True).frontend_len
    assert engine.prefix == P and engine.capacity == P + 32


def test_full_parameter_count():
    """2.51 B parameters at full width (tied embeddings), counted from the
    config; the formula gives the smoke init's count too."""
    def formula(cfg):
        d, f, hd, H, K = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads, cfg.n_kv
        a = d * hd * (H + 2 * K) + H * hd * d
        return cfg.vocab * d + cfg.n_layers * (a + 3 * d * f + 2 * d) + d

    small = get_config(ARCH, smoke=True)
    assert formula(small) == count_params(
        build_model(small, device="cpu").init(0))
    assert formula(get_config(ARCH)) == 2_508_662_784
    assert get_config(ARCH).frontend_len == 256


def test_launch_serve_cpu():
    """``python -m repro_torch.launch.serve --arch paligemma-3b --device
    cpu`` serves the smoke config."""
    from test_torch_families import test_launch_serve_cpu as serve

    serve(ARCH)
