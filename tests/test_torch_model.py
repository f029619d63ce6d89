"""The port's dense models against the JAX reference, weights carried across.

For each dense smoke config the reference's ``api.init`` params go through
``load_reference_params`` into the port; the same numpy-seeded tokens then
go through the reference's prefill and 4 decode steps and through the
port's (attention through K4's plain version on these CPU tensors).

* f32 compute on both sides: logits and caches within atol = rtol = 1e-4.
* bf16 compute: caches within a relative (Frobenius) error of 8e-2 of the
  reference's bf16 caches; logits no further from the reference's f32
  logits, in relative error, than the reference's own bf16 logits are, plus
  8e-2.  Logits are held to the f32 answer because at these 2-layer widths
  bf16 rounding alone moves them by up to 15% in relative norm (the
  reference's own bf16 run against its f32 run), and the two packages round
  at different places: the port's attention keeps scores, softmax and P V
  in f32 (as the flash-attention kernel does), the reference's einsums
  round them to bf16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import count_params as ref_count_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import (build_model, count_params,  # noqa: E402
                                load_reference_params)

DENSE = ["llama3.2-1b", "qwen1.5-0.5b", "qwen2-7b", "qwen3-8b"]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                      jnp.bfloat16)}
B, S, T = 2, 40, 4


def _configs(arch, dtype):
    tdt, jdt = DTYPES[dtype]
    return (dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=tdt),
            dataclasses.replace(ref_get_config(arch, smoke=True),
                                compute_dtype=jdt))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want, dtype, what, f32=None):
    """f32: elementwise 1e-4.  bf16: relative error 8e-2 against the
    reference's bf16 result, or, given the reference's f32 result ``f32``,
    against that, beyond the reference's own bf16 error."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                   err_msg=what)
    elif f32 is None:
        rel = _rel(got, want)
        assert rel <= 8e-2, f"{what}: relative error {rel}"
    else:
        f32 = _np(f32)
        rel, own = _rel(got, f32), _rel(want, f32)
        assert rel <= own + 8e-2, (f"{what}: relative error {rel} from the "
                                   f"f32 answer; the reference's bf16 {own}")


def _stacked(caches, key):
    return torch.stack([c[key] for c in caches])


def _reference_run(rcfg, tree, toks, cap=S + T):
    """The reference's prefill logits, caches, and 4 decode steps."""
    rapi = ref_build_model(rcfg)
    logits, cache = jax.jit(lambda p, b: rapi.prefill(p, b, cap))(
        tree, {"tokens": jnp.asarray(toks[:, :S])})
    out = {"logits": [logits], "prefill_cache": cache}
    decode = jax.jit(rapi.decode_step)
    for t in range(S, S + T):
        logits, cache = decode(tree, cache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
        out["logits"].append(logits)
    out["cache"] = cache
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, dtype):
    cfg, rcfg = _configs(arch, dtype)
    tree = jax.tree.map(np.asarray,
                        ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    api = build_model(cfg, device="cpu")
    params = load_reference_params(cfg, tree, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab, (B, S + T), dtype=np.int32)
    ref = _reference_run(rcfg, tree, toks)
    f32 = (_reference_run(_configs(arch, "f32")[1], tree, toks)["logits"]
           if dtype == "bf16" else [None] * (T + 1))

    got, caches = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                              S + T)
    assert got.dtype == torch.float32 and len(caches) == cfg.n_layers
    _close(got, ref["logits"][0], dtype, f"{arch} prefill logits", f32[0])
    for key in ("k", "v"):
        _close(_stacked(caches, key), ref["prefill_cache"][key], dtype,
               f"{arch} prefill cache {key}")
    assert np.array_equal(_stacked(caches, "abs").numpy(),
                          np.asarray(ref["prefill_cache"]["abs"]))
    for i, t in enumerate(range(S, S + T), start=1):
        got, caches = api.decode_step(params, caches,
                                      torch.from_numpy(toks[:, t]), t)
        _close(got, ref["logits"][i], dtype, f"{arch} decode step {t}",
               f32[i])
    for key in ("k", "v"):
        _close(_stacked(caches, key), ref["cache"][key], dtype,
               f"{arch} decoded cache {key}")
    assert np.array_equal(_stacked(caches, "abs").numpy(),
                          np.asarray(ref["cache"]["abs"]))


@pytest.mark.parametrize("arch", DENSE)
def test_weights_carried_across(arch):
    """Matrices once in the compute dtype, norm scales in f32, the same
    parameter count, and the blocks unstacked in layer order."""
    cfg, rcfg = _configs(arch, "bf16")
    tree = jax.tree.map(np.asarray,
                        ref_build_model(rcfg).init(jax.random.PRNGKey(1)))
    params = load_reference_params(cfg, tree, device="cpu")
    assert count_params(params) == ref_count_params(tree)
    assert params["embed"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32
    last = params["blocks"][-1]
    assert last["ln1"]["scale"].dtype == torch.float32
    assert last["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        last["mlp"]["w_down"].float().numpy(),
        np.asarray(jnp.asarray(tree["blocks"]["mlp"]["w_down"][-1])
                   .astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("arch", DENSE)
def test_port_init_shapes_match_reference(arch):
    """The port's own seeded init has the reference's tree of shapes."""
    cfg = get_config(arch, smoke=True)
    params = build_model(cfg, device="cpu").init(0)
    tree = ref_build_model(ref_get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0))
    assert count_params(params) == ref_count_params(tree)
    for i, bp in enumerate(params["blocks"]):
        for name, w in bp["attn"].items():
            if isinstance(w, torch.Tensor):
                assert w.shape == tree["blocks"]["attn"][name].shape[1:], name
    again = build_model(cfg, device="cpu").init(0)
    assert torch.equal(again["embed"], params["embed"]), "seeded"


def test_full_llama_parameter_count():
    """1,235,814,400 parameters at full width (tied embeddings), counted
    from the config without building the model."""
    cfg = get_config("llama3.2-1b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d
    per_layer = attn + 3 * d * f + 2 * d
    assert cfg.vocab * d + cfg.n_layers * per_layer + d == 1_235_814_400


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("gpt-17")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-medium",
                                  "paligemma-3b"])
def test_build_model_defaults_to_the_card(monkeypatch, arch):
    cfg = get_config(arch, smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert build_model(cfg).device.type == "cuda"
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_sliding_window_matches_reference():
    """A dense model with a sliding window (the ring cache wraps, K4 runs
    with its window lower bound): prefill and decode against the
    reference, f32 compute."""
    cfg, rcfg = (dataclasses.replace(c, swa_window=16)
                 for c in _configs("llama3.2-1b", "f32"))
    tree = jax.tree.map(np.asarray,
                        ref_build_model(rcfg).init(jax.random.PRNGKey(2)))
    params = load_reference_params(cfg, tree, device="cpu")
    api = build_model(cfg, device="cpu")
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (B, S + T),
                                             dtype=np.int32)
    ref = _reference_run(rcfg, tree, toks, cap=16)
    got, caches = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                              16)
    assert caches[0]["k"].shape[1] == 16
    _close(got, ref["logits"][0], "f32", "swa prefill logits")
    for i, t in enumerate(range(S, S + T), start=1):
        got, caches = api.decode_step(params, caches,
                                      torch.from_numpy(toks[:, t]), t)
        _close(got, ref["logits"][i], "f32", f"swa decode step {t}")
    for key in ("k", "v", "abs"):
        _close(_stacked(caches, key), ref["cache"][key], "f32",
               f"swa decoded cache {key}")


def test_swa_window_limits_receptive_field():
    """Single-layer SWA: the last token's logits depend ONLY on the final W
    tokens (as the reference's test of the windowed mask + ring cache)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              n_layers=1, swa_window=16)
    api = build_model(cfg, device="cpu")
    params = api.init(1)
    rng = np.random.default_rng(0)
    t1 = rng.integers(1, cfg.vocab, (1, 24), dtype=np.int32)
    t2 = t1.copy()
    t2[:, :24 - 16] = rng.integers(1, cfg.vocab, (1, 24 - 16))
    l1, _ = api.prefill(params, {"tokens": torch.from_numpy(t1)}, 16)
    l2, _ = api.prefill(params, {"tokens": torch.from_numpy(t2)}, 16)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("mask", ["bidirectional", "prefix"])
def test_masks_off_the_kernel_path_match_reference(mask):
    """The prefix-LM and bidirectional masks, once off K4's path and now
    on it (its plain version on these CPU tensors); f32 against the
    reference's attn_forward with its make_mask."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention as attn

    cfg, rcfg = _configs("llama3.2-1b", "f32")
    p = ref_attn.attn_init(jax.random.PRNGKey(5), rcfg)
    n = 30
    x = np.random.default_rng(6).standard_normal(
        (2, n, cfg.d_model)).astype(np.float32)
    pos = np.arange(n, dtype=np.int32)[None]
    causal, prefix = (False, None) if mask == "bidirectional" else (True, 8)
    want, _ = ref_attn.attn_forward(
        p, rcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        mask=ref_attn.make_mask(n, n, causal=causal, prefix_len=prefix))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got, _ = attn.attn_forward(tp, cfg, torch.from_numpy(x),
                               positions=torch.from_numpy(pos),
                               causal=causal, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------------
# every arch id: the registry, the smoke shapes, the input specs
# ---------------------------------------------------------------------------------

def _smoke_batch(cfg, B=2, S=32, seed=0):
    """The reference's ``test_models_smoke.make_batch``, as torch tensors."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": torch.from_numpy(rng.standard_normal(
                    (B, S, cfg.d_model))).to(cfg.compute_dtype),
                "tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                        (B, S)))}
    if cfg.frontend == "patch":
        P = cfg.frontend_len
        return {"prefix_embeds": torch.from_numpy(rng.standard_normal(
                    (B, P, cfg.d_model))).to(cfg.compute_dtype),
                "tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                        (B, S - P)))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structure(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_shapes(arch):
    """The reference's ``test_models_smoke`` shapes check, every arch id:
    finite [B, V] logits from prefill and a decode step, and caches of the
    same structure after it."""
    from repro_torch.configs import cache_capacity

    cfg = get_config(arch, smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    B, S = 2, 32
    cap = cache_capacity(cfg, S)
    with torch.inference_mode():
        logits, caches = api.prefill(params, _smoke_batch(cfg, B, S), cap)
        before = _structure(caches)
        assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all()), arch
        tok = torch.argmax(logits, dim=-1)
        logits2, caches2 = api.decode_step(params, caches, tok, S)
    assert logits2.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits2).all()), arch
    assert _structure(caches2) == before


def test_full_configs_match_assignment():
    """The exact numbers from the assignment table (the reference's test)."""
    rows = {
        "paligemma-3b": (18, 2048, 8, 1, 16384, 257216),
        "mixtral-8x7b": (32, 4096, 32, 8, 14336, 32000),
        "olmoe-1b-7b": (16, 2048, 16, 16, 1024, 50304),
        "llama3.2-1b": (16, 2048, 32, 8, 8192, 128256),
        "qwen1.5-0.5b": (24, 1024, 16, 16, 2816, 151936),
        "qwen2-7b": (28, 3584, 28, 4, 18944, 152064),
        "qwen3-8b": (36, 4096, 32, 8, 12288, 151936),
        "rwkv6-7b": (32, 4096, 64, 64, 14336, 65536),
        "recurrentgemma-9b": (38, 4096, 16, 1, 12288, 256000),
    }
    for arch, (L, d, H, K, f, V) in rows.items():
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
                cfg.vocab) == (L, d, H, K, f, V), arch
    sm = get_config("seamless-m4t-medium")
    assert (sm.enc_layers, sm.dec_layers, sm.d_model, sm.n_heads,
            sm.d_ff) == (12, 12, 1024, 16, 4096)
    assert sm.vocab == 256_256  # 256206 padded for 16-way vocab sharding
    assert get_config("qwen1.5-0.5b").qkv_bias
    assert get_config("qwen3-8b").qk_norm
    assert get_config("mixtral-8x7b").swa_window == 4096
    assert get_config("mixtral-8x7b").moe.num_experts == 8
    assert get_config("olmoe-1b-7b").moe.top_k == 8
    assert get_config("recurrentgemma-9b").local_window == 2048
    assert get_config("paligemma-3b").prefix_lm


@pytest.mark.parametrize("smoke", [False, True])
def test_every_config_is_the_reference_config(smoke):
    """``ARCH_IDS`` and ``all_configs`` hold the reference's ten ids in its
    order, each config equal to the reference's field for field (dtypes
    and the MoE sub-config compared apart)."""
    from repro.configs import ARCH_IDS as REF_IDS
    from repro.configs import all_configs as ref_all_configs
    from repro_torch.configs import all_configs

    assert ARCH_IDS == REF_IDS and len(ARCH_IDS) == 10
    ours, ref = all_configs(smoke), ref_all_configs(smoke)
    assert list(ours) == list(ref)
    for arch, cfg in ours.items():
        for f in dataclasses.fields(cfg):
            if f.name in ("param_dtype", "compute_dtype", "moe"):
                continue
            assert getattr(cfg, f.name) == getattr(ref[arch], f.name), \
                (arch, f.name)
        assert (cfg.moe is None) == (ref[arch].moe is None)
        if cfg.moe is not None:
            assert dataclasses.asdict(cfg.moe) == \
                dataclasses.asdict(ref[arch].moe)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch):
    """``batch_specs`` and ``decode_specs`` on meta tensors, against the
    reference's ShapeDtypeStructs at every assigned shape."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import batch_specs as ref_batch_specs
    from repro.configs import decode_specs as ref_decode_specs
    from repro_torch.configs import SHAPES, batch_specs, decode_specs

    names = {torch.int32: "int32", torch.bfloat16: "bfloat16",
             torch.float32: "float32"}
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert list(SHAPES) == list(REF_SHAPES)
    for name, shape in SHAPES.items():
        got, want = batch_specs(cfg, shape), ref_batch_specs(rcfg,
                                                             REF_SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[key].shape), (arch, key)
            assert names[spec.dtype] == str(want[key].dtype), (arch, key)
        for g, w in zip(decode_specs(shape), ref_decode_specs(
                REF_SHAPES[name])):
            assert tuple(g.shape) == tuple(w.shape) and g.device.type == \
                "meta" and names[g.dtype] == str(w.dtype)


def test_layernorm_matches_reference():
    """``layernorm`` (public, as in the reference; no model calls it)."""
    from repro.models import common as ref_common
    from repro_torch.models import common

    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    p = common.layernorm_init(48, device="cpu")
    p = {"scale": p["scale"] * 1.5, "bias": p["bias"] + 0.25}
    rp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    for tdt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                          (torch.bfloat16, jnp.bfloat16, 2e-2)):
        got = common.layernorm(p, torch.from_numpy(x).to(tdt))
        want = ref_common.layernorm(rp, jnp.asarray(x, jdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)
    assert sorted(ref_common.layernorm_init(48)) == sorted(p)
