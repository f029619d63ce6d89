"""The MoE and recurrent model families of the port against the JAX
reference, weights carried across: mixtral-8x7b and olmoe-1b-7b (block
kind ``moe``), rwkv6-7b (``rwkv``) and recurrentgemma-9b (``griffin``,
with its rg-lru tail), at their smoke sizes on the CPU.

The same numpy-seeded tokens go through the reference's prefill and 4
decode steps and through the port's (K4's, ``wkv6_scan``'s and
``rglru_scan``'s plain versions on these CPU tensors), with
``test_torch_model.py``'s rule: f32 logits and every cache leaf within
atol = rtol = 1e-4; bf16 caches within a relative (Frobenius) error of
8e-2 of the reference's bf16 caches and logits no further from the
reference's f32 logits than the reference's own bf16 logits are, plus
8e-2.  Then decode against a fresh prefill (the reference's
``test_serving.py`` checks, ported) and ``ServeEngine``'s greedy tokens
against the reference's engine, f32.
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
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, cache_capacity, get_config  # noqa
from repro_torch.models import (build_model, count_params,  # noqa: E402
                                load_reference_params)
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

FAMILIES = ["mixtral-8x7b", "olmoe-1b-7b", "rwkv6-7b", "recurrentgemma-9b"]
FULL_COUNTS = {"mixtral-8x7b": 46_702_792_704, "olmoe-1b-7b": 6_919_100_416,
               "rwkv6-7b": 7_576_621_056, "recurrentgemma-9b": 9_396_408_320}
KINDS = {"mixtral-8x7b": "moe", "olmoe-1b-7b": "moe", "rwkv6-7b": "rwkv",
         "recurrentgemma-9b": "griffin"}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
B, S, T = 2, 40, 4


def _configs(arch, dtype, **kw):
    tdt, jdt = DTYPES[dtype]
    return (dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=tdt, **kw),
            dataclasses.replace(ref_get_config(arch, smoke=True),
                                compute_dtype=jdt, **kw))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(got, want) -> float:
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got))


def _flat(tree):
    """{path: array} of a cache tree; the port's per-layer lists are
    stacked on a leading axis, as the reference stacks them."""
    if isinstance(tree, list):
        parts = [_flat(c) for c in tree]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    if isinstance(tree, dict):
        return {f"{key}/{k}".rstrip("/"): v for key, val in tree.items()
                for k, v in _flat(val).items()}
    return {"": _np(tree)}


def _close(got, want, dtype, what, f32=None):
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


def _close_caches(got, want, dtype, what):
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want), what
    for key in want:
        if key.endswith("abs"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{what} {key}")
        else:
            _close(got[key], want[key], dtype, f"{what} {key}")


def _reference_run(rcfg, tree, toks, cap):
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


def _tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        ref_build_model(rcfg).init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch, dtype):
    cfg, rcfg = _configs(arch, dtype)
    tree = _tree(rcfg)
    api = build_model(cfg, device="cpu")
    params = load_reference_params(cfg, tree, device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (B, S + T),
                                             dtype=np.int32)
    cap = cache_capacity(cfg, S + T)
    ref = _reference_run(rcfg, tree, toks, cap)
    f32 = (_reference_run(_configs(arch, "f32")[1], tree, toks,
                          cap)["logits"]
           if dtype == "bf16" else [None] * (T + 1))
    got, caches = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                              cap)
    assert got.dtype == torch.float32
    _close(got, ref["logits"][0], dtype, f"{arch} prefill logits", f32[0])
    _close_caches(caches, ref["prefill_cache"], dtype, f"{arch} prefill")
    for i, t in enumerate(range(S, S + T), start=1):
        got, caches = api.decode_step(params, caches,
                                      torch.from_numpy(toks[:, t]), t)
        _close(got, ref["logits"][i], dtype, f"{arch} decode step {t}",
               f32[i])
    _close_caches(caches, ref["cache"], dtype, f"{arch} decoded")


@pytest.mark.parametrize("arch", FAMILIES)
def test_weights_carried_across(arch):
    """The same parameter count, blocks (and griffin's tail) unstacked in
    layer order, and each leaf in the dtype of the port's own init: f32
    where the reference uses the parameter in f32, else bf16."""
    cfg, rcfg = _configs(arch, "bf16")
    tree = _tree(rcfg, seed=1)
    params = load_reference_params(cfg, tree, device="cpu")
    own = build_model(cfg, device="cpu").init(0)
    assert count_params(params) == ref_count_params(tree) == count_params(own)
    n_blocks, n_tail = lm._n_scanned(cfg)
    assert len(params["blocks"]) == n_blocks
    assert len(params.get("tail", [])) == n_tail
    got = {k: (v.dtype, v.shape) for k, v in _leaves(params)}
    assert got == {k: (v.dtype, v.shape) for k, v in _leaves(own)}
    f32 = sorted({k.rsplit("/", 1)[-1] for k, (dt, _) in got.items()
                  if dt == torch.float32})
    assert f32 == {"mixtral-8x7b": ["router", "scale"],
                   "olmoe-1b-7b": ["router", "scale"],
                   "rwkv6-7b": ["gn_scale", "scale", "u", "w0", "wd2"],
                   "recurrentgemma-9b": ["b_i", "b_r", "lam", "scale", "w_i",
                                         "w_r"]}[arch]
    last = params["blocks"][-1]
    name, key = {"moe": ("moe", "w_down"), "rwkv": ("cm", "wv"),
                 "griffin": ("sub0", "mlp")}[KINDS[arch]]
    want = tree["blocks"][name][key] if KINDS[arch] != "griffin" else \
        tree["blocks"]["sub0"]["mlp"]["w_down"]
    leaf = last[name][key] if KINDS[arch] != "griffin" else \
        last["sub0"]["mlp"]["w_down"]
    np.testing.assert_array_equal(
        leaf.float().numpy(),
        np.asarray(jnp.asarray(want[-1]).astype(jnp.bfloat16), np.float32))


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")


def test_f32_keys_follow_the_layer():
    """An rg-lru ``mix`` keeps its gates in f32, an attention ``mix`` of
    the same model keeps everything but its norms in the compute dtype."""
    cfg, rcfg = _configs("recurrentgemma-9b", "bf16")
    params = load_reference_params(cfg, _tree(rcfg), device="cpu")
    block = params["blocks"][0]
    assert block["sub0"]["mix"]["w_r"].dtype == torch.float32
    assert block["sub2"]["mix"]["wq"].dtype == torch.bfloat16
    assert convert.f32_keys("mix", block["sub2"]["mix"]) == {"scale"}


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_prefill(arch):
    """Token-by-token decode reproduces the logits of a fresh prefill over
    the extended sequence; bf16 compute, the reference test's tolerance
    (``tests/test_serving.py``, which runs mixtral, rwkv6 and
    recurrentgemma).  olmoe's smoke prefill drops up to 8% of its slots at
    capacity factor 1.25 where a two-token decode step drops none, which
    legitimately changes its logits (``test_olmoe_prefill_drops_slots``),
    so it runs here at a capacity that holds every slot (factor E / k)."""
    cfg = get_config(arch, smoke=True)
    if arch == "olmoe-1b-7b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    rng = np.random.default_rng(42)
    b, s, t_new = 2, 24, 4
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (b, s + t_new),
                                         dtype=np.int32))
    cap = cache_capacity(cfg, s + t_new)
    logits, caches = api.prefill(params, {"tokens": toks[:, :s]}, cap)
    for t in range(s, s + t_new):
        ref_logits, _ = api.prefill(params, {"tokens": toks[:, :t + 1]}, cap)
        logits, caches = api.decode_step(params, caches, toks[:, t], t)
        np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                                   atol=0.08, rtol=0.08,
                                   err_msg=f"{arch} step {t}")


def test_olmoe_prefill_drops_slots(monkeypatch):
    """At olmoe's capacity factor the 24-token smoke prefill drops slots
    that a decode step (C = 8 for 2 tokens) keeps: why
    ``test_decode_matches_prefill`` gives olmoe a capacity for every
    slot."""
    from repro_torch.models import ffn

    cfg = get_config("olmoe-1b-7b", smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    dropped = []
    moe_tokens = ffn._moe_tokens

    def spy(p, c, x):
        out, aux = moe_tokens(p, c, x)
        dropped.append((x.shape[0] * x.shape[1],
                        float(aux["dropped_fraction"])))
        return out, aux

    monkeypatch.setattr(ffn, "_moe_tokens", spy)
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        1, cfg.vocab, (2, 25), dtype=np.int32))
    _, caches = api.prefill(params, {"tokens": toks[:, :24]}, 25)
    api.decode_step(params, caches, toks[:, 24], 24)
    assert max(f for n, f in dropped if n == 48) > 0
    assert all(f == 0 for n, f in dropped if n == 2)


def test_swa_window_limits_receptive_field():
    """Single-layer SWA (mixtral's smoke window, the MoE taken out as in
    the reference's test: capacity couples tokens): the last token's
    logits depend only on the final W tokens."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True),
                              n_layers=1, moe=None)
    api = build_model(cfg, device="cpu")
    params = api.init(1)
    rng = np.random.default_rng(0)
    W = cfg.swa_window
    t1 = rng.integers(1, cfg.vocab, (1, 24), dtype=np.int32)
    t2 = t1.copy()
    t2[:, :24 - W] = rng.integers(1, cfg.vocab, (1, 24 - W))
    cap = cache_capacity(cfg, 24)
    l1, _ = api.prefill(params, {"tokens": torch.from_numpy(t1)}, cap)
    l2, _ = api.prefill(params, {"tokens": torch.from_numpy(t2)}, cap)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-3, rtol=1e-3)


def test_local_attention_limits_receptive_field():
    """recurrentgemma's local attention sub-block alone: its output at the
    last token depends only on the final ``local_window`` tokens, and the
    ring cache keeps exactly those."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    api = build_model(cfg, device="cpu")
    sub = api.init(2)["blocks"][0]["sub2"]
    rng = np.random.default_rng(1)
    W, n = cfg.local_window, 30
    x1 = torch.from_numpy(rng.standard_normal((1, n, cfg.d_model))).to(
        cfg.compute_dtype)
    x2 = x1.clone()
    x2[:, :n - W] = torch.from_numpy(
        rng.standard_normal((1, n - W, cfg.d_model))).to(cfg.compute_dtype)
    pos = torch.arange(n, dtype=torch.int32)[None]
    y1, c1 = lm._apply_griffin_sub(sub, cfg, x1, pos, "attn", capacity=64)
    y2, _ = lm._apply_griffin_sub(sub, cfg, x2, pos, "attn", capacity=64)
    torch.testing.assert_close(y1[:, -1], y2[:, -1] - x2[:, -1] + x1[:, -1])
    assert c1["k"].shape[1] == W
    assert sorted(c1["abs"].tolist()) == list(range(n - W, n))


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_reference_engine(arch):
    """Same params, same prompts, f32: the same greedy tokens as the
    reference's ServeEngine (left-padding with token 0 and no padding
    mask, as there; two batches, the second partial)."""
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


def test_griffin_caches_have_the_reference_shape():
    """{"main": per super-block {sub0, sub1, sub2}, "tail": per tail
    layer}; the local attention's cache holds min(capacity, window)."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    api = build_model(cfg, device="cpu")
    toks = torch.ones((1, 20), dtype=torch.int32)
    _, caches = api.prefill(api.init(0), {"tokens": toks}, 20)
    n_blocks, n_tail = lm._n_scanned(cfg)
    assert (n_blocks, n_tail) == (1, 2)
    assert sorted(caches) == ["main", "tail"]
    assert len(caches["main"]) == n_blocks and len(caches["tail"]) == n_tail
    assert sorted(caches["main"][0]) == ["sub0", "sub1", "sub2"]
    assert sorted(caches["tail"][0]) == ["conv", "h"]
    assert caches["main"][0]["sub2"]["k"].shape[1] == cfg.local_window


def test_griffin_subs_are_the_reference_super_block():
    """``GRIFFIN_SUBS``, which the init, prefill and decode all read,
    names the reference's sub-blocks in order, each with the reference's
    temporal mix: the same leaves, of the same shapes, under ``mix``."""
    cfg, rcfg = _configs("recurrentgemma-9b", "f32")
    ref_block = _tree(rcfg, seed=0)["blocks"]
    own = build_model(cfg, device="cpu").init(0)["blocks"][0]
    assert [sub for sub, _ in lm.GRIFFIN_SUBS] == list(ref_block) == \
        list(own)
    for sub, temporal in lm.GRIFFIN_SUBS:
        want = {k: tuple(v.shape[1:])
                for k, v in ref_block[sub]["mix"].items()}
        got = {k: tuple(v.shape) for k, v in own[sub]["mix"].items()}
        assert got == want, sub
        assert ("lam" in got) == (temporal == "rglru"), sub


@pytest.mark.parametrize("arch", FAMILIES)
def test_arch_is_ported(arch):
    """The id is served, its block kind is the reference's, and both its
    configs equal the reference's field for field (dtypes aside)."""
    assert arch in ARCH_IDS
    assert lm.block_kind(get_config(arch)) == KINDS[arch]
    for smoke in (False, True):
        full, ref = get_config(arch, smoke), ref_get_config(arch, smoke)
        for f in dataclasses.fields(full):
            if f.name not in ("param_dtype", "compute_dtype", "moe"):
                assert getattr(full, f.name) == getattr(ref, f.name), f.name
        assert (full.moe is None) == (ref.moe is None)
        if ref.moe is not None:
            assert dataclasses.asdict(full.moe) == dataclasses.asdict(ref.moe)


def _formula(cfg) -> int:
    """Parameters of ``cfg`` by the formula of its block kind."""
    d, f, hd, H, K = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads, cfg.n_kv
    attn = (d * hd * (H + 2 * K) + H * hd * d
            + (2 * hd if cfg.qk_norm else 0))
    kind = lm.block_kind(cfg)
    if kind == "moe":
        E = cfg.moe.num_experts
        n = cfg.n_layers * (attn + d * E + 3 * E * d * f + 2 * d)
    elif kind == "rwkv":
        H_r = d // 64
        tm = (d + 5 * d + d * 5 * 32 + 5 * 32 * d + 5 * d * d + d + d * 64
              + 64 * d + H_r * 64 + d)
        cm = 2 * d + 2 * d * f + d * d
        n = cfg.n_layers * (tm + cm + 2 * d)
    else:
        R, Kc = cfg.rnn_width, cfg.conv_kernel
        rg = 2 * d * R + Kc * R + R + 2 * R * R + 3 * R + R * d
        sub = 3 * d * f + 2 * d
        blocks, tail = lm._n_scanned(cfg)
        n = blocks * (2 * (rg + sub) + attn + sub) + tail * (rg + sub)
    return n + cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + d


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_parameter_count(arch):
    """The formula of each block kind gives the port's init at smoke width,
    and at full width (no full-width model is built): mixtral 46.7 B,
    olmoe 6.9 B, rwkv6 7.6 B, recurrentgemma 9.4 B (tied embeddings)."""
    small = get_config(arch, smoke=True)
    assert _formula(small) == count_params(
        build_model(small, device="cpu").init(0))
    assert _formula(get_config(arch)) == FULL_COUNTS[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <id> --device cpu``
    serves the smoke config."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--requests", "3", "--new-tokens", "4"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("device: cpu")
    assert "served 3 requests, 12 tokens" in proc.stdout
