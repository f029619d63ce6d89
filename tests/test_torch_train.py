"""The port's training substrate against the JAX reference, on the CPU.

* ``train.optim``: ``lr_at``, ``clip_by_global_norm``/``global_norm`` and
  AdamW against the reference's on the same trees (f32: the scalars
  within 1e-6 relative, the updated trees within 1e-5, the norm summing
  its leaves in another order), and the reference's own cases.
* ``train.step``: the port's versions of ``test_train.py`` (the loss
  decreases, microbatch accumulation equals the full batch, a restart
  from a checkpoint is bit-faithful, here on every leaf), and a step's
  gradients are deterministic.
* ``checkpoint.store`` and ``data.pipeline``: the port's versions of
  ``test_checkpoint_data.py``; the batches equal the reference's bit for
  bit; a checkpoint written by either package restores into the other's
  tree (the port's per-layer lists stacked under the reference's keys).
* ``models.convert``: the f32 master tree and its working copy.
* ``launch.train`` (``--supervise --fail-at``) and the two training
  examples, on the CPU.
* The model levers of ``test_perf_levers.py`` that apply to the port.
"""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticTokenPipeline as RefPipeline  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.train import optim as ref_optim  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_pytree, save_pytree)
from repro_torch.checkpoint.store import latest_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.models import (build_model, load_reference_master,  # noqa
                                master_params, working_params)
from repro_torch.models.convert import layer_stacks  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig,  # noqa: E402
                               init_train_state, lr_at, make_train_step)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402
from repro_torch.train.step import (_split_microbatches,  # noqa: E402
                                    value_and_grad)

ROOT = Path(__file__).parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small operations, which a
    pool of threads in each of a whole run's worker processes slows by up
    to two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("llama3.2-1b", smoke=True)
    api = build_model(cfg, device="cpu")
    data = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                             global_batch=8, seed=0))
    return cfg, api, data


def _tokens(data, i):
    return {"tokens": torch.from_numpy(data.batch_at(i)["tokens"])}


# ---------------------------------------------------------------------------------
# optimizer against the reference's
# ---------------------------------------------------------------------------------

def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32) * 30,
                  "d": rng.standard_normal((2, 3, 2)).astype(np.float32)}}


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(v.copy())) for k, v in tree.items()}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_lr_at_matches_reference():
    oc = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                   min_lr_ratio=0.1)
    roc = ref_optim.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        got = lr_at(oc, torch.tensor(step, dtype=torch.int32))
        want = ref_optim.lr_at(roc, jnp.int32(step))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_lr_schedule():
    oc = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                   min_lr_ratio=0.1)
    assert float(lr_at(oc, torch.tensor(0, dtype=torch.int32))) < 2e-4
    assert float(lr_at(oc, 10)) == pytest.approx(1e-3, rel=1e-2)
    assert float(lr_at(oc, 100)) == pytest.approx(1e-4, rel=1e-2)


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((3,), -10.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(700.0))
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_matches_reference(max_norm):
    tree = _random_tree(3)
    got, norm = optim.clip_by_global_norm(_torch_tree(tree), max_norm)
    want, rnorm = ref_optim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    assert float(norm) == pytest.approx(float(rnorm), rel=1e-6)
    for a, b in zip(tree_leaves(got), _np_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_matches_reference(clip_norm):
    """Three AdamW steps from the same tree and gradients (clipped and
    not): parameters, m, v, step and the metrics of each step."""
    oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                   clip_norm=clip_norm)
    roc = ref_optim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                              clip_norm=clip_norm)
    params = _torch_tree(_random_tree(0))
    rparams = jax.tree.map(jnp.asarray, _random_tree(0))
    state = optim.init_opt_state(params)
    rstate = ref_optim.init_opt_state(rparams)
    for i in range(3):
        grads = _random_tree(10 + i)
        params, state, m = optim.adamw_update(oc, params, _torch_tree(grads),
                                              state)
        rparams, rstate, rm = ref_optim.adamw_update(
            roc, rparams, jax.tree.map(jnp.asarray, grads), rstate)
        assert int(state["step"]) == int(rstate["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(rm[key]), rel=1e-6)
        for tree, rtree in ((params, rparams), (state["m"], rstate["m"]),
                            (state["v"], rstate["v"])):
            for a, b in zip(tree_leaves(tree), _np_leaves(rtree)):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                           atol=1e-8)


# ---------------------------------------------------------------------------------
# the train step (the reference's test_train.py)
# ---------------------------------------------------------------------------------

def test_loss_decreases(setup):
    cfg, api, data = setup
    tcfg = TrainConfig(opt=OptConfig(lr=2e-3, warmup_steps=5,
                                     total_steps=60))
    step = make_train_step(api, tcfg)
    state = init_train_state(api, 0)
    assert all(t.dtype == torch.float32
               for t in tree_leaves(state["params"]))
    losses = []
    for i in range(35):
        state, m = step(state, _tokens(data, i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.25, losses


def test_grad_accum_matches_full_batch(setup):
    """Accumulated microbatch gradients equal the full-batch gradient (the
    reference test's tolerances: bf16 forward), and the train step's
    losses agree across accumulation settings."""
    cfg, api, data = setup
    state = init_train_state(api, 1)
    batch = _tokens(data, 0)
    (_, _), full = value_and_grad(api, state["params"], batch)
    for accum in (2, 4):
        mbs = _split_microbatches(batch, accum)
        acc = [torch.zeros_like(g) for g in tree_leaves(full)]
        for i in range(accum):
            _, g = value_and_grad(api, state["params"],
                                  {k: v[i] for k, v in mbs.items()})
            for a, gi in zip(acc, tree_leaves(g)):
                a += gi
        for a, b in zip(acc, tree_leaves(full)):
            np.testing.assert_allclose((a / accum).numpy(), b.numpy(),
                                       atol=2e-2, rtol=5e-2)
    losses = {}
    for accum in (1, 2, 4):
        tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1),
                           accum_steps=accum)
        fresh = init_train_state(api, 1)
        _, m = make_train_step(api, tcfg)(fresh, batch)
        losses[accum] = float(m["loss"])
        assert sorted(m) == ["grad_norm", "load_balance_loss", "loss", "lr",
                             "xent"]
    assert losses[1] == pytest.approx(losses[2], rel=2e-3)
    assert losses[1] == pytest.approx(losses[4], rel=2e-3)


def test_accumulation_arithmetic_is_the_references():
    """With accum_steps 2 the step's gradient is (g0 + g1) / 2 summed in
    f32 from zeros, and the loss (l0 + l1) / 2: the state after one step
    equals AdamW applied to exactly that."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    api = build_model(cfg, device="cpu")
    data = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                             global_batch=4, seed=2))
    batch = _tokens(data, 0)
    oc = OptConfig(lr=1e-3, warmup_steps=1)
    state = init_train_state(api, 2)
    mbs = _split_microbatches(batch, 2)
    parts = [value_and_grad(api, state["params"], {k: v[i] for k, v in
                                                   mbs.items()})
             for i in range(2)]
    grads = optim.tree_map(lambda a, b: (torch.zeros_like(a) + a + b) / 2,
                           parts[0][1], parts[1][1])
    want = init_train_state(api, 2)
    optim.adamw_update(oc, want["params"], grads, want["opt"])
    _, m = make_train_step(api, TrainConfig(opt=oc, accum_steps=2))(state,
                                                                     batch)
    assert torch.equal(m["loss"], (parts[0][0][0] + parts[1][0][0]) / 2)
    for a, b in zip(tree_leaves(state), tree_leaves(want)):
        assert torch.equal(a, b)


def test_step_gradients_are_deterministic(setup):
    cfg, api, data = setup
    state = init_train_state(api, 5)
    runs = [value_and_grad(api, state["params"], _tokens(data, 3))
            for _ in range(2)]
    assert torch.equal(runs[0][0][0], runs[1][0][0])
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_checkpoint_restart_is_bit_faithful(tmp_path, setup):
    """Crash/restart equivalence: train 6 steps straight == train 3, save,
    restore into a fresh state, train 3 more (same data stream): every
    leaf of the state bit for bit."""
    cfg, api, _ = setup
    data = SyntheticTokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                             global_batch=8, seed=9))
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=2))
    step = make_train_step(api, tcfg)

    straight = init_train_state(api, 7)
    for i in range(6):
        straight, _ = step(straight, _tokens(data, i))

    state = init_train_state(api, 7)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for i in range(3):
        state, _ = step(state, _tokens(data, i))
    mgr.save(state, 3, extra={"data": {"step": 3}})
    restored, meta = mgr.restore_latest(init_train_state(api, 11))
    assert meta["step"] == 3
    for i in range(3, 6):
        restored, _ = step(restored, _tokens(data, i))
    for a, b in zip(tree_leaves(straight), tree_leaves(restored)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------------
# checkpoint store and data pipeline (the reference's test_checkpoint_data.py)
# ---------------------------------------------------------------------------------

def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32),
                  "step": torch.tensor(5, dtype=torch.int32)},
            "layers": [{"w": torch.full((2,), float(i)),
                        "n": {"scale": torch.ones(3) * i}} for i in range(3)]}


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    save_pytree(t, str(tmp_path), 7, extra={"note": "x"})
    template = optim.tree_map(lambda x: torch.empty_like(x, device="meta"), t)
    restored, meta = restore_pytree(template, str(tmp_path))
    assert meta["step"] == 7 and meta["extra"]["note"] == "x"
    assert "layers__n__scale" in meta["keys"]
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomic_commit_ignores_tmp(tmp_path):
    t = tree()
    save_pytree(t, str(tmp_path), 1)
    os.makedirs(tmp_path / "step_00000009.tmp-999-123")   # a crashed write
    assert latest_step(str(tmp_path)) == 1
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(t, 2)
    assert not any(".tmp" in d for d in os.listdir(tmp_path))  # GC'd


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = tree()
    for s in (1, 2, 3, 4):
        mgr.save(t, s)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_shape_mismatch_rejected(tmp_path):
    save_pytree(tree(), str(tmp_path), 1)
    bad = tree()
    bad["a"] = torch.zeros((3, 3))
    with pytest.raises(ValueError):
        restore_pytree(bad, str(tmp_path))
    fewer = tree()
    fewer["layers"] = fewer["layers"][:2]
    with pytest.raises(ValueError):
        restore_pytree(fewer, str(tmp_path))


def test_data_determinism_and_resume():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=4, seed=3)
    p1 = SyntheticTokenPipeline(cfg)
    p2 = SyntheticTokenPipeline(cfg, start_step=0)
    np.testing.assert_array_equal(p1.batch_at(5)["tokens"],
                                  p2.batch_at(5)["tokens"])
    p2.load_state_dict({"step": 17})
    assert p2.step == 17


def test_data_sharding_partitions_global_batch():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=1)
    whole = SyntheticTokenPipeline(cfg).batch_at(3)["tokens"]
    for n in (4, 2):
        shards = [SyntheticTokenPipeline(cfg, shard=s, num_shards=n)
                  .batch_at(3)["tokens"] for s in range(n)]
        np.testing.assert_array_equal(np.concatenate(shards), whole)


def test_data_tokens_in_vocab():
    cfg = DataConfig(vocab=100, seq_len=64, global_batch=2, seed=0)
    toks = SyntheticTokenPipeline(cfg).batch_at(0)["tokens"]
    assert toks.min() >= 0 and toks.max() < 100


@pytest.mark.parametrize("seed,vocab", [(0, 512), (9, 128256)])
def test_batches_equal_the_references(seed, vocab):
    cfg = DataConfig(vocab=vocab, seq_len=96, global_batch=4, seed=seed)
    rcfg = RefDataConfig(vocab=vocab, seq_len=96, global_batch=4, seed=seed)
    for step in (0, 1, 17):
        got = SyntheticTokenPipeline(cfg, shard=1, num_shards=2).batch_at(
            step)["tokens"]
        want = RefPipeline(rcfg, shard=1, num_shards=2).batch_at(
            step)["tokens"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------------

CROSS_ARCHS = ["llama3.2-1b", "recurrentgemma-9b", "seamless-m4t-medium"]


def _ref_state(arch, seed):
    rcfg = ref_get_config(arch, smoke=True)
    rapi = ref_build_model(rcfg)
    return rapi, jax.jit(lambda k: ref_train.init_train_state(rapi, k))(
        jax.random.PRNGKey(seed))


def _port_state_from(arch, rstate):
    """The reference's train state as the port's: the f32 master by
    ``load_reference_master``, m and v likewise, the step as int32."""
    cfg = get_config(arch, smoke=True)
    conv = jax.tree.map(np.asarray, rstate)
    return {"params": load_reference_master(cfg, conv["params"], "cpu"),
            "opt": {"m": load_reference_master(cfg, conv["opt"]["m"], "cpu"),
                    "v": load_reference_master(cfg, conv["opt"]["v"], "cpu"),
                    "step": torch.tensor(int(conv["opt"]["step"]),
                                         dtype=torch.int32)}}


def _by_path(tree, parts=()):
    """{path: tensor} of a port tree (list indices in the path)."""
    if isinstance(tree, torch.Tensor):
        return {parts: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, val in items:
        out.update(_by_path(val, parts + (key,)))
    return out


def _assert_same(got, want):
    got, want = _by_path(got), _by_path(want)
    assert sorted(got, key=str) == sorted(want, key=str)
    for key, val in want.items():
        assert got[key].dtype == val.dtype and torch.equal(got[key], val), key


def _perturbed(state, seed):
    """Distinct values in every leaf (m, v and step too)."""
    gen = torch.Generator().manual_seed(seed)
    out = optim.tree_map(
        lambda t: (t + torch.rand(t.shape, generator=gen)).to(t.dtype)
        if t.is_floating_point() else t + 3, state)
    return out


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_port_checkpoint_restores_into_the_reference(tmp_path, arch):
    rapi, rstate = _ref_state(arch, 0)
    state = _perturbed(_port_state_from(arch, rstate), 1)
    save_pytree(state, str(tmp_path), 4, extra={"data": {"step": 4}})
    template = jax.eval_shape(lambda: rstate)
    restored, meta = ref_ckpt.restore_pytree(template, str(tmp_path))
    assert meta["step"] == 4
    _assert_same(_port_state_from(arch, restored), state)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch):
    rapi, rstate = _ref_state(arch, 2)
    rstate = jax.tree.map(lambda x: x + 1 if x.dtype == jnp.int32
                          else x * 1.5 + 0.25, rstate)
    ref_ckpt.save_pytree(rstate, str(tmp_path), 6)
    cfg = get_config(arch, smoke=True)
    template = init_train_state(build_model(cfg, device="cpu"), 0)
    restored, meta = restore_pytree(template, str(tmp_path))
    assert meta["step"] == 6
    want = _port_state_from(arch, rstate)
    assert len(restored["params"][next(iter(layer_stacks(cfg)))]) == \
        next(iter(layer_stacks(cfg).values()))
    _assert_same(restored, want)


# ---------------------------------------------------------------------------------
# convert: the master tree and its working copy
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-7b", "mixtral-8x7b"])
def test_master_and_working_params(arch):
    """``load_reference_master`` keeps the reference's f32 values in every
    leaf; ``working_params`` casts the leaves ``load_reference_params``
    casts, to the same values, and the casts carry the gradient back to
    the master in f32."""
    from repro_torch.models import load_reference_params

    cfg = get_config(arch, smoke=True)
    rapi, rstate = _ref_state(arch, 3)
    tree = jax.tree.map(np.asarray, rstate["params"])
    master = load_reference_master(cfg, tree, "cpu")
    served = load_reference_params(cfg, tree, "cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(master))
    work = working_params(cfg, master)
    for w, s in zip(tree_leaves(work), tree_leaves(served)):
        assert w.dtype == s.dtype and torch.equal(w, s)
    leaf = master["embed"].requires_grad_()
    working_params(cfg, master)["embed"].float().sum().backward()
    assert leaf.grad.dtype == torch.float32
    own = master_params(build_model(cfg, device="cpu").init(0))
    assert all(t.dtype == torch.float32 for t in tree_leaves(own))


# ---------------------------------------------------------------------------------
# the launcher and the examples
# ---------------------------------------------------------------------------------

def test_launch_train_supervised_restart(tmp_path, capsys):
    """``--supervise --fail-at``: the injected failure, a restart from the
    latest checkpoint, and the same final state as a run without one."""
    from repro_torch.launch import train as launch

    args = ["--steps", "9", "--batch", "4", "--seq", "32", "--ckpt-every",
            "3", "--log-every", "4", "--device", "cpu"]
    launch.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--supervise",
                        "--fail-at", "4"])
    out = capsys.readouterr().out
    assert "injected failure at step 4" in out
    assert "resumed from step 3" in out
    plain = launch.run(launch.parser().parse_args(
        args + ["--ckpt-dir", str(tmp_path / "b")]))
    resumed = launch.run(launch.parser().parse_args(
        args + ["--ckpt-dir", str(tmp_path / "a"), "--resume"]))
    assert resumed["losses"] == []           # the last commit is step 9
    template = init_train_state(build_model(get_config(
        "llama3.2-1b", smoke=True), device="cpu"), 0)
    final, meta = restore_pytree(template, str(tmp_path / "a"))
    assert meta["step"] == 9
    for a, b in zip(tree_leaves(final), tree_leaves(plain["state"])):
        assert torch.equal(a, b)


def test_launch_train_layers_cuts_the_depth():
    """``--layers N`` builds the config cut to N layers and trains it (a
    patch-frontend model, fed its zero patch embeddings)."""
    from repro_torch.launch import train as launch

    args = launch.parser().parse_args(
        ["--arch", "paligemma-3b", "--layers", "1", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt-every", "0", "--device",
         "cpu"])
    cfg, api, _ = launch.build(args)
    assert cfg.n_layers == 1 and len(api.init(0)["blocks"]) == 1
    out = launch.run(args)
    assert len(out["losses"]) == 2 and all(
        np.isfinite(out["losses"] + out["grad_norms"]))


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_learns():
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert out["final_loss"] < out["first_loss"] - 0.2


def test_torch_fault_tolerant_train_resumes(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the launcher's process
    out = _example("torch_fault_tolerant_train").main(["--device", "cpu"])
    assert "injected failure" in out and "resumed from step 5" in out


# ---------------------------------------------------------------------------------
# the model levers of test_perf_levers.py
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "paligemma-3b"])
def test_attn_chunk_q_leaves_the_loss_unchanged(arch):
    """``attn_chunk_q`` (the reference's query-chunked attention) is read
    by nothing: K4 takes every mask; the loss is the same bit for bit."""
    cfg = get_config(arch, smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40),
                                                     dtype=np.int32))}
    if cfg.frontend == "patch":
        batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    chunked = build_model(dataclasses.replace(cfg, attn_chunk_q=16),
                          device="cpu")
    with torch.no_grad():
        assert torch.equal(api.loss(params, batch)[0],
                           chunked.loss(params, batch)[0])


def test_moe_dispatch_modes_agree():
    """per_sequence dispatch ~= global (capacity grouping noise only)."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    params = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32),
                                                     dtype=np.int32))}
    with torch.no_grad():
        g = float(build_model(cfg, device="cpu").loss(params, batch)[0])
        ps = float(build_model(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="per_sequence")),
            device="cpu").loss(params, batch)[0])
    assert g == pytest.approx(ps, abs=0.3)


def test_scripts_import_no_jax():
    """The training modules and examples of the port import neither jax
    nor the reference."""
    import subprocess

    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.train, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.launch.train; "
            "import runpy; "
            "[runpy.run_path(p, run_name='x') for p in "
            "('examples/torch_quickstart.py', "
            "'examples/torch_fault_tolerant_train.py')]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={**os.environ, "PYTHONPATH": ""})
