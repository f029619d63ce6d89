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
from repro_torch.configs import ARCH_IDS, NOT_PORTED, get_config  # noqa: E402
from repro_torch.models import (ModelConfig, MoEConfig,  # noqa: E402
                                build_model, count_params,
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


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_unported_arch_ids_raise(arch):
    with pytest.raises(NotImplementedError, match="not have yet"):
        get_config(arch)
    assert arch not in ARCH_IDS


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("gpt-17")


@pytest.mark.parametrize("family", ["moe", "rwkv", "griffin", "encdec",
                                    "patch"])
def test_unported_families_raise(family):
    base = get_config("llama3.2-1b", smoke=True)
    cfg = {
        "moe": dataclasses.replace(base, moe=MoEConfig(4, 2)),
        "rwkv": dataclasses.replace(base, attn_pattern="rwkv"),
        "griffin": dataclasses.replace(base, attn_pattern="griffin_1_2"),
        "encdec": dataclasses.replace(base, enc_layers=2, dec_layers=2),
        "patch": dataclasses.replace(base, frontend="patch"),
    }[family]
    assert isinstance(cfg, ModelConfig)
    with pytest.raises(NotImplementedError):
        build_model(cfg, device="cpu")


def test_build_model_defaults_to_the_card(monkeypatch):
    cfg = get_config("llama3.2-1b", smoke=True)
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
    """Prefix-LM and bidirectional masks stay on the plain attention; f32
    against the reference's attn_forward with its make_mask."""
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
