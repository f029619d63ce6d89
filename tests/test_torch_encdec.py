"""The port's encoder-decoder family (seamless-m4t-medium) against the JAX
reference, weights carried across, at its smoke size on the CPU.

The same numpy-seeded frames and tokens go through the reference's
prefill and 4 decode steps and through the port's (K4's plain version on
these CPU tensors: the bidirectional encoder, the causal decoder and the
cross-attention).  f32: logits and every cache leaf (the decoder's self
k/v/abs, ``cross_k``, ``cross_v``) within rtol = 1e-4 and an atol of 1e-4
times the leaf's largest magnitude where that exceeds 1 (``close``): the
second decoder layer's keys reach 13 here, and the reference itself moves
them by 1.3e-4 when its frames move by 1e-7 relative, so an absolute 1e-4
lies below the model's own f32 noise there.  bf16, ``test_torch_model.py``'s
rule: caches within a relative (Frobenius) error of 8e-2 of the reference's
bf16 caches, logits no further from the reference's f32 logits than the
reference's own bf16 logits are, plus 8e-2.  Then
decode against a fresh prefill (the reference's ``test_serving.py``
protocol: 16 random frames) and ``ServeEngine``'s greedy tokens against the
reference's engine, f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import attention as ref_attn  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import count_params as ref_count_params  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import cache_capacity, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import (build_model, count_params,  # noqa: E402
                                load_reference_params)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from test_torch_families import (DTYPES, _close, _configs,  # noqa: E402
                                 _flat, _leaves, _tree)

ARCH = "seamless-m4t-medium"
B, S, T = 2, 40, 4
S_ENC = 16


def close(got, want, dtype, what, f32=None):
    """The module's rule (see its docstring)."""
    if dtype != "f32":
        return _close(got, want, dtype, what, f32)
    got, want = (np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                            np.float32) for x in (got, want))
    assert got.shape == want.shape and np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-4,
                               err_msg=what)


def close_caches(got, want, dtype, what):
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want), what
    for key in want:
        if key.endswith("abs"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{what} {key}")
        else:
            close(got[key], want[key], dtype, f"{what} {key}")


def modality(cfg, b, seed=1234) -> dict:
    """Random frames / patch embeddings as numpy f32 (the reference's
    ``test_serving._fixed_modality``: made once from a stream of their
    own)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal((b, S_ENC, cfg.d_model))
                .astype(np.float32)}
    if cfg.frontend == "patch":
        return {"prefix_embeds": rng.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)}
    return {}


def prefix_of(cfg) -> int:
    return cfg.frontend_len if cfg.frontend == "patch" else 0


def ref_batch(rcfg, toks, mod) -> dict:
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v, rcfg.compute_dtype) for k, v in mod.items()}}


def port_batch(cfg, toks, mod) -> dict:
    return {"tokens": torch.from_numpy(toks),
            **{k: torch.from_numpy(v).to(cfg.compute_dtype)
               for k, v in mod.items()}}


def reference_run(rcfg, tree, toks, mod, cap):
    """The reference's prefill logits and caches, and 4 decode steps at
    the absolute positions after the prefix."""
    rapi = ref_build_model(rcfg)
    pos0 = prefix_of(rcfg)
    logits, cache = jax.jit(lambda p, b: rapi.prefill(p, b, cap))(
        tree, ref_batch(rcfg, toks[:, :S], mod))
    out = {"logits": [logits], "prefill_cache": cache}
    decode = jax.jit(rapi.decode_step)
    for t in range(S, S + T):
        logits, cache = decode(tree, cache, jnp.asarray(toks[:, t]),
                               jnp.int32(pos0 + t))
        out["logits"].append(logits)
    out["cache"] = cache
    return out


def check_against_reference(arch, dtype):
    """Prefill logits, every cache leaf, 4 decode steps and the decoded
    caches of the port against the reference (module rule)."""
    cfg, rcfg = _configs(arch, dtype)
    tree = _tree(rcfg)
    api = build_model(cfg, device="cpu")
    params = load_reference_params(cfg, tree, device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (B, S + T),
                                             dtype=np.int32)
    mod = modality(cfg, B)
    pos0 = prefix_of(cfg)
    cap = cache_capacity(cfg, pos0 + S + T)
    ref = reference_run(rcfg, tree, toks, mod, cap)
    f32 = (reference_run(_configs(arch, "f32")[1], tree, toks, mod,
                         cap)["logits"]
           if dtype == "bf16" else [None] * (T + 1))
    got, caches = api.prefill(params, port_batch(cfg, toks[:, :S], mod), cap)
    assert got.dtype == torch.float32
    close(got, ref["logits"][0], dtype, f"{arch} prefill logits", f32[0])
    close_caches(caches, ref["prefill_cache"], dtype, f"{arch} prefill")
    for i, t in enumerate(range(S, S + T), start=1):
        got, caches = api.decode_step(params, caches,
                                      torch.from_numpy(toks[:, t]), pos0 + t)
        close(got, ref["logits"][i], dtype, f"{arch} decode step {t}",
              f32[i])
    close_caches(caches, ref["cache"], dtype, f"{arch} decoded")
    return caches


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_match_reference(dtype):
    caches = check_against_reference(ARCH, dtype)
    cfg = get_config(ARCH, smoke=True)
    assert len(caches) == cfg.dec_layers
    assert sorted(caches[0]) == ["cross_k", "cross_v", "self"]
    assert caches[0]["cross_k"].shape == (B, S_ENC, cfg.n_kv, cfg.hd)


def test_weights_carried_across():
    """The same parameter count as the reference and the port's own init,
    the encoder and decoder unstacked in layer order, each leaf of the
    port's own init's dtype and shape (f32 only the norm scales)."""
    cfg, rcfg = _configs(ARCH, "bf16")
    tree = _tree(rcfg, seed=1)
    params = load_reference_params(cfg, tree, device="cpu")
    own = build_model(cfg, device="cpu").init(0)
    assert count_params(params) == ref_count_params(tree) == count_params(own)
    assert len(params["encoder"]) == cfg.enc_layers
    assert len(params["decoder"]) == cfg.dec_layers
    got = {k: (v.dtype, v.shape) for k, v in _leaves(params)}
    assert got == {k: (v.dtype, v.shape) for k, v in _leaves(own)}
    assert sorted({k.rsplit("/", 1)[-1] for k, (dt, _) in got.items()
                   if dt == torch.float32}) == ["scale"]
    assert sorted(params) == sorted(tree)
    np.testing.assert_array_equal(
        params["decoder"][-1]["cross_attn"]["wq"].float().numpy(),
        np.asarray(jnp.asarray(tree["decoder"]["cross_attn"]["wq"][-1])
                   .astype(jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(
        params["head"].float().numpy(),
        np.asarray(jnp.asarray(tree["head"]).astype(jnp.bfloat16),
                   np.float32))


def test_encoder_is_bidirectional_and_matches_reference():
    """``encode`` against the reference's, f32; and its first position
    sees the last frame."""
    cfg, rcfg = _configs(ARCH, "f32")
    tree = _tree(rcfg, seed=2)
    params = load_reference_params(cfg, tree, device="cpu")
    frames = modality(cfg, B, seed=5)["frames"]
    want = ref_encdec.encode(tree, rcfg, jnp.asarray(frames))
    got = encdec.encode(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    other = frames.copy()
    other[:, -1] += 1.0
    moved = encdec.encode(params, cfg, torch.from_numpy(other))
    assert not torch.allclose(moved[:, 0], got[:, 0], atol=1e-3)


def test_cross_attention_matches_reference():
    """``attn_forward`` with ``kv_x`` (Sq 24 against Sk 16 memory rows),
    keys not rotated, the bidirectional mask: against the reference's,
    f32, and through the same kernel call as every other mask."""
    cfg, rcfg = _configs(ARCH, "f32")
    p = ref_attn.attn_init(jax.random.PRNGKey(3), rcfg)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 24, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)[None]
    want, (wk, wv) = ref_attn.attn_forward(
        p, rcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        mask=ref_attn.make_mask(24, S_ENC, causal=False),
        kv_x=jnp.asarray(mem),
        kv_positions=jnp.arange(S_ENC, dtype=jnp.int32)[None],
        use_rope=False)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got, (gk, gv) = attn.attn_forward(tp, cfg, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos),
                                      kv_x=torch.from_numpy(mem),
                                      use_rope=False, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5,
                               rtol=1e-5)


def spy_attention(monkeypatch) -> dict:
    """Record each call of K4's entry point (its mask form and shapes) and
    of the plain ``_gqa_attend``."""
    calls = {"flash": [], "plain": 0}
    flash, plain = ops.flash_attention, attn._gqa_attend

    def flash_spy(q, k, v, **kw):
        calls["flash"].append((kw.get("causal", True), kw.get("prefix_len"),
                               q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)

    def plain_spy(*args):
        calls["plain"] += 1
        return plain(*args)

    monkeypatch.setattr(ops, "flash_attention", flash_spy)
    monkeypatch.setattr(attn, "_gqa_attend", plain_spy)
    return calls


def test_every_prefill_attention_goes_through_the_kernel(monkeypatch):
    """A prefill runs the encoder's bidirectional self-attentions, the
    decoder's causal ones and its cross-attentions (Sq the text's length,
    Sk the frames') all through K4, and none through ``_gqa_attend``; a
    decode step runs two plain attentions a decoder layer and no K4."""
    cfg = get_config(ARCH, smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    calls = spy_attention(monkeypatch)
    toks = np.ones((B, 24), np.int32)
    _, caches = api.prefill(params, port_batch(cfg, toks, modality(cfg, B)),
                            24)
    L_e, L_d = cfg.enc_layers, cfg.dec_layers
    assert calls["plain"] == 0
    assert sorted(calls["flash"]) == sorted(
        [(False, None, S_ENC, S_ENC)] * L_e + [(True, None, 24, 24)] * L_d
        + [(False, None, 24, S_ENC)] * L_d)
    calls["flash"].clear()
    api.decode_step(params, caches, torch.ones(B, dtype=torch.int64), 24)
    assert calls["flash"] == [] and calls["plain"] == 2 * L_d


def test_decode_matches_prefill():
    """Token-by-token decode reproduces the logits of a fresh prefill over
    the extended sequence with the same 16 random frames; bf16 compute,
    the reference test's tolerance (``tests/test_serving.py``)."""
    cfg = get_config(ARCH, smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    rng = np.random.default_rng(42)
    b, s, t_new = 2, 24, 4
    toks = rng.integers(1, cfg.vocab, (b, s + t_new), dtype=np.int32)
    mod = modality(cfg, b)
    cap = cache_capacity(cfg, s + t_new)
    logits, caches = api.prefill(params, port_batch(cfg, toks[:, :s], mod),
                                 cap)
    for t in range(s, s + t_new):
        ref_logits, _ = api.prefill(params,
                                    port_batch(cfg, toks[:, :t + 1], mod),
                                    cap)
        logits, caches = api.decode_step(params, caches,
                                         torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                                   atol=0.08, rtol=0.08,
                                   err_msg=f"{ARCH} step {t}")


def engine_matches_reference_engine(arch):
    """Same params, same prompts, f32: the same greedy tokens as the
    reference's ServeEngine (zero modality inputs, left-padding with token
    0, two batches, the second partial)."""
    cfg, rcfg = _configs(arch, "f32")
    rapi = ref_build_model(rcfg)
    tree = rapi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(5, 32, 5)]
    ref = RefServeEngine(rapi, tree, batch_size=2, seq_len=32).run(
        [RefRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    params = load_reference_params(cfg, jax.tree.map(np.asarray, tree),
                                   device="cpu")
    engine = ServeEngine(build_model(cfg, device="cpu"), params,
                         batch_size=2, seq_len=32)
    got = engine.run([Request(rid=i, prompt=p, max_new_tokens=6)
                      for i, p in enumerate(prompts)])
    assert [r.output for r in got] == [r.output for r in ref]
    assert engine.stats["tokens"] == 5 * 6
    return engine


def test_engine_matches_reference_engine():
    engine = engine_matches_reference_engine(ARCH)
    assert engine.prefix == 0 and engine.capacity == 32


def test_full_parameter_count():
    """0.877 B parameters at full width: an untied head, embeddings of the
    padded vocab, 12 encoder and 12 decoder layers; the formula gives the
    smoke init's count too."""
    def formula(cfg):
        d, f, hd, H, K = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads, cfg.n_kv
        a = d * hd * (H + 2 * K) + H * hd * d
        return (2 * cfg.vocab * d + cfg.enc_layers * (a + 2 * d * f + 2 * d)
                + cfg.dec_layers * (2 * a + 2 * d * f + 3 * d) + 2 * d)

    small = get_config(ARCH, smoke=True)
    assert formula(small) == count_params(
        build_model(small, device="cpu").init(0))
    assert formula(get_config(ARCH)) == 877_197_312


def test_launch_serve_cpu():
    """``python -m repro_torch.launch.serve --arch seamless-m4t-medium
    --device cpu`` serves the smoke config."""
    from test_torch_families import test_launch_serve_cpu as serve

    serve(ARCH)
