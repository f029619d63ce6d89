"""The port's serving path on the CPU: decode against prefill, the engine
against the JAX reference's engine, the request queue, and the entry point.

Every port object is built with ``device="cpu"``, where the prefill's
attention runs K4's plain version; ``chip_smoke.py`` serves llama3.2-1b at
full width through the CUDA kernel.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import cache_capacity, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build_model, load_reference_params  # noqa: E402
from repro_torch.serving import (Request, RequestQueue,  # noqa: E402
                                 ServeEngine)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-8b"])
def test_decode_matches_prefill(arch):
    """Token-by-token decode (plain attention over the cache) reproduces the
    logits of a fresh prefill (K4) over the extended sequence; bf16 compute,
    the reference test's tolerance."""
    cfg = get_config(arch, smoke=True)
    api = build_model(cfg, device="cpu")
    params = api.init(0)
    rng = np.random.default_rng(42)
    B, S, T = 2, 24, 4
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S + T),
                                         dtype=np.int32))
    cap = cache_capacity(cfg, S + T)
    logits, caches = api.prefill(params, {"tokens": toks[:, :S]}, cap)
    for t in range(S, S + T):
        ref_logits, _ = api.prefill(params, {"tokens": toks[:, :t + 1]}, cap)
        logits, caches = api.decode_step(params, caches, toks[:, t], t)
        np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                                   atol=0.08, rtol=0.08,
                                   err_msg=f"{arch} step {t}")


def test_engine_matches_reference_engine():
    """Same params, same prompts, f32 compute: the same greedy tokens as the
    JAX ServeEngine (left-padding with token 0 and no padding mask, as
    there; two batches, the second one partial)."""
    rcfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                               compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
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
    assert engine.stats["tokens"] == 2 * 6 + 2 * 6 + 1 * 6
    assert len(engine.stats["prefill_s"]) == 3


def test_request_queue_partial_batch_flush():
    """A sub-batch tail waits for a full batch only up to ``flush_after``
    seconds of head age; ``flush=True`` forces it out immediately."""
    now = {"t": 0.0}
    q = RequestQueue(batch_size=4, seq_len=32, flush_after=5.0,
                     clock=lambda: now["t"])
    reqs = [Request(rid=i, prompt=np.array([1, 2], np.int32),
                    max_new_tokens=1) for i in range(6)]
    q.submit(reqs[0])
    q.submit(reqs[1])
    assert q.next_batch() is None, "partial batch held back while young"
    now["t"] = 4.9
    assert q.next_batch() is None
    now["t"] = 5.0
    batch = q.next_batch()
    assert batch is not None and [r.rid for r in batch] == [0, 1]
    now["t"] = 10.0
    for r in reqs[2:6]:
        q.submit(r)
    assert [r.rid for r in q.next_batch()] == [2, 3, 4, 5]
    q.submit(Request(rid=9, prompt=np.array([1], np.int32), max_new_tokens=1))
    assert [r.rid for r in q.next_batch(flush=True)] == [9]
    assert q.next_batch(flush=True) is None, "empty queue stays None"
    eager = RequestQueue(batch_size=4, seq_len=32)
    eager.submit(Request(rid=11, prompt=np.array([1], np.int32),
                         max_new_tokens=1))
    assert [r.rid for r in eager.next_batch()] == [11]
    padded = eager.pad_prompts([Request(rid=1, prompt=np.array([5, 6, 7]))])
    assert padded.shape == (4, 32) and list(padded[0, -3:]) == [5, 6, 7]
    assert not padded[0, :-3].any() and not padded[1:].any()


def test_serve_engine_end_to_end():
    cfg = get_config("llama3.2-1b", smoke=True)
    api = build_model(cfg, device="cpu")
    engine = ServeEngine(api, api.init(0), batch_size=2, seq_len=32)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, 12,
                                               dtype=np.int32),
                    max_new_tokens=5) for i in range(5)]
    before = fa.flash_attention.launches
    done = engine.run(reqs)
    assert fa.flash_attention.launches == before, "CPU tensors: plain"
    assert all(r.done for r in done)
    assert all(len(r.output) == 5 for r in done)
    assert engine.stats["tokens"] > 0
    # deterministic greedy decode: same prompt -> same output
    r_a = Request(rid=10, prompt=done[0].prompt, max_new_tokens=5)
    engine.run([r_a])
    assert r_a.output == done[0].output


def test_serve_engine_defaults_to_the_card(monkeypatch):
    cfg = get_config("llama3.2-1b", smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    engine = ServeEngine(build_model(cfg), params={}, batch_size=1,
                         seq_len=8)
    assert engine.device.type == "cuda"


def test_launch_serve_cpu_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--new-tokens", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests, 12 tokens" in proc.stdout
    assert proc.stdout.startswith("device: cpu")
