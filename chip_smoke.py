#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. The card's name and power limit (``nvidia-smi``), then the build of every
   CUDA source (``nvcc`` for sm_90a, one process per source, all started
   together), with each source's ``ptxas -v`` lines.  ``cuobjdump -sass``
   of the flash-attention library counts the ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions of each bf16 kernel; a count of 0
   fails the run.
2. ``[kernels]``: each topo-score kernel against its plain PyTorch version on
   the card, bit for bit (tiers, per-tile argmax, scores), over all three
   server specs, several requests with the exactness traps in their inputs,
   and n in {256, 1500, 65536}; ``placement_tier`` also against host
   ``best_tier``.
3. ``[main]``: the scheduler path, ``run_hit_rate_experiment`` (the paper's
   Table 4 protocol, ``TopoScheduler.plan()`` per scale-up) with
   ``imp_pallas`` and then host ``imp`` on the 100-node Table 3 cluster (2
   cycles x 50 scale-ups, which must give 100/100/0/0) and on a 1024-node
   cluster (1 x 20); the decisions of the two engines must be identical.
   Launch counters are set to 0 just before each ``imp_pallas`` run and
   read just after it: the topo_score_argmax launches must equal the
   engine's per-node calls less its host fallbacks, and be > 0.  Then the
   20-node 3 x 10 protocol must give 30/30/0.
4. ``[flash]``: the flash-attention kernel (K4) against its plain version on
   the card, in f32 (2e-5) and bf16 (2.5e-2), over the reference tests'
   five shapes, the serving path's shape, a head_dim-128 shape, a window
   with fully masked first tiles, a ragged Sq at the 128-row q block and a
   windowed head_dim-128 shape whose length is not a multiple of 128; no
   output may be non-finite.  Then 50 back-to-back launches at the serving
   shape must give bit-identical outputs.
5. ``[serve]``: the serving path, llama3.2-1b at full width and depth with
   seeded random weights made on the card, through ``ServeEngine`` (batch
   4, seq_len 1024): 8 requests of 512-1024 prompt tokens and 32 new tokens
   each.  Counters at 0 just before, read just after: K4 launches must be
   16 layers x 2 prefill batches.  Every request has 32 tokens, no logit is
   non-finite, and the first batch served again gives the same tokens.
   ``[serve-trace]`` profiles one prefill and one decode step.
6. ``[serve-check]``: decode against prefill at full width.  2 sequences of
   1000 tokens, then 4 decode steps; each step's logits within 0.08 of a
   fresh prefill (through K4) of the extended sequence, with the depth cut
   to 2 layers.  The full depth's differences are recorded beside them, and
   so is how far each layer amplifies a 1e-6 perturbation of the input
   (f32): the random-weight model is chaotic at depth (``serve_check``).
7. One ``{"kernels": [...]}`` line: per kernel its launches on its path,
   the largest difference against the plain version, the time per call
   from CUDA events (kernel and plain version), the device time per launch
   from torch.profiler, the bound and the share of it the kernel reaches,
   the function's operations over the kernel's time (``tflops``), and the
   time of one PyTorch library call of the same function where there is
   one.  Then a ``[trace]`` line: one
   traced ``imp_pallas`` plan on 1024 nodes, its device time against its
   sourcing wall time, and the host functions that dominate.
8. The card's name and power limit again, then the last line
   ``{"ok": true, "device": {...}}``.

With no CUDA device, or without ``src/repro_torch`` beside this file, it
exits with a non-zero code and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, f32
#: FLOP/s outside the tensor cores, bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
SIZES = (256, 1500, 65536)
#: (need_gpus, need_cgs, cgs_per_bundle, alpha): every need size, a
#: zero-need request, an unbundled one, cnt_cg // 2, and alpha 0 / 1
REQUESTS = ((1, 1, 1, 0.5), (2, 2, 1, 0.0), (4, 4, 0, 1.0), (8, 8, 1, 0.5),
            (0, 0, 0, 0.5), (2, 4, 2, 0.3))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------------

def lanes(torch, np, spec, n, seed, dev):
    """Seeded int32 lanes with the traps: zero masks and priorities, large
    priority sums, k = K_INFEASIBLE, a random ok mask, a fully masked tile."""
    from repro_torch.kernels.topo_score import K_INFEASIBLE, TILE

    rng = np.random.default_rng(seed)
    g = rng.integers(0, spec.all_gpu_mask + 1, n).astype(np.int32)
    c = rng.integers(0, spec.all_cg_mask + 1, n).astype(np.int32)
    g[::17] = 0
    c[::19] = 0
    p = rng.integers(0, 3000 * 16, n).astype(np.int32)
    p[::7] = 0
    k = rng.integers(0, 17, n).astype(np.int32)
    k[::23] = K_INFEASIBLE
    ok = (rng.random(n) < 0.7).astype(np.int32)
    if n > TILE:
        ok[TILE:2 * TILE] = 0
    return [torch.from_numpy(x).to(dev) for x in (g, c, p, k, ok)]


def compare(torch, got, want, what: str) -> float:
    """Bitwise equality of each output pair; returns the max |difference|
    over finite floats (0.0 when bitwise equal)."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: output {i} is {a.dtype}{tuple(a.shape)}, plain "
              f"{b.dtype}{tuple(b.shape)}")
        if a.dtype == torch.float32:
            fin = torch.isfinite(b)
            if bool(fin.any()):
                err = max(err, float((a[fin] - b[fin]).abs().max()))
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            same = torch.equal(a, b)
        check(same, f"{what}: output {i} differs from the plain version "
              f"(max |diff| {err})")
    return err


def kernel_phase(torch, np, dev) -> dict[str, float]:
    from repro_torch.core.placement import best_tier
    from repro_torch.core.topology import SPECS
    from repro_torch.kernels import topo_score as ts

    errs = {"topo_score_argmax": 0.0, "topo_score": 0.0,
            "placement_tier": 0.0}
    cases = 0
    for si, name in enumerate(sorted(SPECS)):
        spec = SPECS[name]
        for ri, (ng, nc, cpb, alpha) in enumerate(REQUESTS):
            req = ts.TopoRequest(ng, nc, cpb, alpha=alpha)
            for n in SIZES:
                g, c, p, k, ok = lanes(torch, np, spec, n + 1,
                                       seed=100 * si + 10 * ri + n, dev=dev)
                # n lanes at offset 0 (16-byte vector path) and at offset 1
                # (scalar path: the views are 4 bytes off alignment)
                for off in (0, 1):
                    x = [t[off:off + n] for t in (g, c, p, k, ok)]
                    what = f"{name} req={ng, nc, cpb, alpha} n={n} off={off}"
                    errs["topo_score_argmax"] = max(
                        errs["topo_score_argmax"], compare(
                            torch, ts.topo_score_argmax(*x[:4], spec, req,
                                                        ok=x[4]),
                            ts.topo_score_argmax_plain(*x[:4], spec, req,
                                                       ok=x[4]),
                            "topo_score_argmax " + what))
                    errs["topo_score"] = max(errs["topo_score"], compare(
                        torch, ts.topo_score(*x[:3], spec, req),
                        ts.topo_score_plain(*x[:3], spec, req),
                        "topo_score " + what))
                    errs["placement_tier"] = max(
                        errs["placement_tier"], compare(
                            torch, [ts.placement_tier(x[0], x[1], spec, req)],
                            [ts.placement_tier_plain(x[0], x[1], spec, req)],
                            "placement_tier " + what))
                    cases += 1
            # placement_tier against host best_tier, every lane of n = 1500
            g, c = lanes(torch, np, spec, 1500, seed=7 + si, dev=dev)[:2]
            tier = ts.placement_tier(g, c, spec, req).cpu().tolist()
            # the best_tier flag(s) this request encodes
            for bundle in [b for b in (True, False)
                           if (nc // ng if (b and ng) else 0) == cpb]:
                want = [best_tier(spec, gi, ci, ng, nc, bundle)
                        for gi, ci in zip(g.cpu().tolist(), c.cpu().tolist())]
                check(tier == want, f"placement_tier {name} "
                      f"req={ng, nc, cpb} differs from host best_tier")
    torch_sync(dev)
    print(f"[kernels] {cases} cases x 3 kernels bit-exact against the plain "
          f"versions; placement_tier == host best_tier", flush=True)
    return errs


# ---------------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------------

def reset_counts() -> None:
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels import topo_score as ts

    for w in WRAPPERS:
        w.launches = 0
    ts.flextopo_imp_pallas.calls = 0
    ts.flextopo_imp_pallas.overflow = 0


def read_counts() -> dict[str, int]:
    from repro_torch.kernels import WRAPPERS
    from repro_torch.kernels import topo_score as ts

    out = {w.__name__: w.launches for w in WRAPPERS}
    out["imp_pallas_calls"] = ts.flextopo_imp_pallas.calls
    out["imp_pallas_overflow"] = ts.flextopo_imp_pallas.overflow
    return out


def protocol(num_nodes, cycles, scaleups, engine, dev):
    from repro_torch.core.simulator import SimConfig, run_hit_rate_experiment

    cfg = SimConfig(num_nodes=num_nodes, seed=0, device=dev)
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    rep = run_hit_rate_experiment(cfg, engine, cycles=cycles,
                                  scaleups_per_cycle=scaleups)
    torch_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    summary = {
        "nodes": num_nodes, "cycles": cycles, "scaleups": scaleups,
        "engine": engine, "preemptions": rep.preemptions, "hits": rep.hits,
        "failures": rep.failures, "placed": rep.placements,
        "sourcing_p50_us": rep.percentile(50),
        "sourcing_p90_us": rep.percentile(90),
        "samples": len(rep.sourcing_us), "wall_s": wall, "counts": counts,
    }
    print(f"[main] {json.dumps(summary)}", flush=True)
    return rep, summary


def torch_sync(dev) -> None:
    import torch

    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def main_path(dev) -> tuple[list[dict], dict[str, int]]:
    from repro_torch.kernels import topo_score as ts

    runs = []
    launches = {w.__name__: 0 for w in ts.WRAPPERS}
    for nodes, cycles, scaleups, expect in ((100, 2, 50, (100, 100, 0, 0)),
                                            (1024, 1, 20, None),
                                            (20, 3, 10, (30, 30, 0, 0))):
        fast, s_fast = protocol(nodes, cycles, scaleups, "imp_pallas", dev)
        c = s_fast["counts"]
        check(c["topo_score_argmax"] > 0,
              f"{nodes} nodes: imp_pallas never launched topo_score_argmax")
        check(c["topo_score_argmax"]
              == c["imp_pallas_calls"] - c["imp_pallas_overflow"],
              f"{nodes} nodes: {c['topo_score_argmax']} launches for "
              f"{c['imp_pallas_calls']} calls less "
              f"{c['imp_pallas_overflow']} host fallbacks")
        for name in launches:
            launches[name] += c[name]
        got = (fast.preemptions, fast.hits, fast.failures, fast.placements)
        if expect is not None:
            check(got == expect, f"{nodes} nodes: imp_pallas gave {got}, "
                  f"the reference gives {expect}")
        runs.append(s_fast)
        if nodes == 20:
            continue
        host, s_host = protocol(nodes, cycles, scaleups, "imp", dev)
        check(fast.decision_keys == host.decision_keys,
              f"{nodes} nodes: imp_pallas and imp decisions differ")
        runs.append(s_host)
        print(f"[main] {nodes} nodes: {len(fast.decision_keys)} decisions "
              f"identical between imp_pallas and imp", flush=True)
    return runs, launches


# ---------------------------------------------------------------------------------
# Phase 4: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------------

#: B, H, K, Sq, Sk, d, causal, window: the reference tests' five shapes, the
#: serving path's (llama3.2-1b prefill, batch 4 x 1024), a head_dim-128
#: shape, a window whose first KV tile is fully masked for some rows, a
#: ragged Sq at the bf16 kernel's 128-row q block, and a windowed
#: head_dim-128 shape whose length is not a multiple of 128
FLASH_SHAPES = (
    (2, 4, 2, 128, 128, 32, True, None),
    (1, 4, 1, 200, 200, 16, True, None),
    (2, 2, 2, 96, 96, 64, True, 32),
    (1, 8, 4, 64, 256, 32, False, None),
    (1, 2, 2, 257, 257, 16, True, 100),
    (4, 32, 8, 1024, 1024, 64, True, None),
    (1, 28, 4, 1500, 1500, 128, True, None),
    (1, 8, 2, 600, 600, 128, True, 100),
    (2, 16, 4, 1000, 1000, 64, True, None),
    (2, 8, 2, 777, 777, 128, True, 250),
)
#: back-to-back launches at the serving shape that must agree bit for bit
REPEATS = 50
MAIN_FLASH = FLASH_SHAPES[5]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2.5e-2}


def flash_inputs(torch, shape, dtype, seed):
    B, H, K, Sq, Sk, d = shape[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in ((B, H, Sq, d), (B, K, Sk, d), (B, K, Sk, d))]


def flash_phase(torch) -> dict[str, float]:
    from repro_torch.kernels import flash_attention as fa

    errs = {}
    for i, shape in enumerate(FLASH_SHAPES):
        causal, window = shape[6], shape[7]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = flash_inputs(torch, shape, dtype, seed=i)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"flash {shape} {name}: non-finite output")
            tol = FLASH_TOL[name]
            err = float((out.float() - want.float()).abs().max())
            check(torch.allclose(out.float(), want.float(), atol=tol,
                                 rtol=tol),
                  f"flash {shape} {name}: max |diff| {err} against the "
                  f"plain version (tolerance {tol})")
            errs[name] = max(errs.get(name, 0.0), err)
            if shape == MAIN_FLASH:
                errs[f"{name}_main"] = err
    print(f"[flash] {len(FLASH_SHAPES)} shapes x 2 dtypes within tolerance "
          f"of the plain version: {json.dumps(errs)}", flush=True)
    q, k, v = flash_inputs(torch, MAIN_FLASH, torch.bfloat16, seed=5)
    first = fa.flash_attention(q, k, v, causal=True)
    outs = [fa.flash_attention(q, k, v, causal=True) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    same = sum(torch.equal(o, first) for o in outs)
    check(same == REPEATS, f"flash: {REPEATS - same} of {REPEATS} repeated "
          f"launches at {MAIN_FLASH[:6]} differ from the first")
    print(f"[flash] {REPEATS} back-to-back launches at {MAIN_FLASH[:6]} bf16 "
          "bit-identical", flush=True)
    return errs


# ---------------------------------------------------------------------------------
# Phase 5: the serving path
# ---------------------------------------------------------------------------------

SERVE_BATCH, SERVE_SEQ, SERVE_REQUESTS, SERVE_NEW = 4, 1024, 8, 32


def checked_api(api, finite: list):
    """The same model API, recording whether each step's logits are all
    finite (one device-side flag per step, read after the run)."""
    import dataclasses

    import torch

    def prefill(p, b, cap):
        logits, caches = api.prefill(p, b, cap)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    def decode_step(p, c, t, pos):
        logits, caches = api.decode_step(p, c, t, pos)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    return dataclasses.replace(api, prefill=prefill, decode_step=decode_step)


def serve_phase(torch, np) -> tuple[dict, object, object]:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config("llama3.2-1b")
    api = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = api.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    finite: list = []
    engine = ServeEngine(checked_api(api, finite), params,
                         batch_size=SERVE_BATCH, seq_len=SERVE_SEQ)
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_SEQ // 2, SERVE_SEQ + 1, SERVE_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, int(n), dtype=np.int32)
               for n in lengths]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                        # counts at 0 just before the path
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()                # and read just after it
    peak = torch.cuda.max_memory_allocated()
    launches = counts["flash_attention"]
    want = cfg.n_layers * -(-SERVE_REQUESTS // SERVE_BATCH)
    check(launches > 0 and launches == want,
          f"serve: {launches} flash_attention launches, expected {want} "
          f"({cfg.n_layers} layers x prefill batches)")
    check(all(len(r.output) == SERVE_NEW for r in reqs),
          f"serve: token counts {[len(r.output) for r in reqs]}")
    check(all(bool(f) for f in finite), "serve: non-finite logits")
    again = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=SERVE_NEW)
             for r in reqs[:SERVE_BATCH]]
    engine.run(again)
    check([r.output for r in again] == [r.output for r in reqs[:SERVE_BATCH]],
          "serve: the same prompts served again gave other tokens")
    dec = engine.stats["decode_s"][:2 * SERVE_NEW]
    out = {
        "model": cfg.name, "params": count_params(params),
        "layers": cfg.n_layers, "batch": SERVE_BATCH, "seq_len": SERVE_SEQ,
        "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
        "prompt_lengths": [int(n) for n in lengths], "init_s": init_s,
        "wall_s": wall, "prefill_s": engine.stats["prefill_s"][:2],
        "decode_p50_ms": 1e3 * float(np.percentile(dec, 50)),
        "decode_p90_ms": 1e3 * float(np.percentile(dec, 90)),
        "tok_per_s": SERVE_REQUESTS * SERVE_NEW / wall,
        "max_memory_allocated": peak, "counts": counts,
        "repeat_identical": True,
    }
    print(f"[serve] {json.dumps(out)}", flush=True)
    return out, api, params


def _traced(torch, fn) -> dict:
    """Run fn once under torch.profiler: its wall time, its device time by
    kernel, and the flash-attention kernel's share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + ev.device_time_total
    total = sum(by_kernel.values())
    flash = sum(t for name, t in by_kernel.items()
                if "flash_bf16_kernel" in name)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_us": wall * 1e6, "device_us": total,
            "device_busy_share": total / (wall * 1e6), "flash_us": flash,
            "flash_share": flash / total if total else None,
            "top_us": [[name[:60], t] for name, t in top]}


def serve_trace(torch, api, params) -> dict:
    """Where one prefill (batch 4 x 1024) and one decode step spend their
    device time, by kernel: the K4 share of a prefill."""
    toks = torch.randint(1, api.cfg.vocab, (SERVE_BATCH, SERVE_SEQ),
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    state = {}

    def prefill():
        state["logits"], state["caches"] = api.prefill(
            params, {"tokens": toks}, SERVE_SEQ)

    def decode():
        api.decode_step(params, state["caches"], state["logits"].argmax(-1),
                        SERVE_SEQ)

    with torch.inference_mode():
        prefill()                                    # warm
        out = {"prefill": _traced(torch, prefill)}
        decode()                                     # warm
        out["decode"] = _traced(torch, decode)
    print(f"[serve-trace] {json.dumps(out)}", flush=True)
    return out


def decode_vs_prefill(torch, np, api, params) -> list[tuple[float, bool]]:
    """2 sequences of 1000 tokens, then 4 decode steps: per step the largest
    |difference| from a fresh prefill (through K4) of the extended
    sequence, and whether it is within 0.08 (atol and rtol)."""
    from repro_torch.configs import cache_capacity

    B, S, T = 2, 1000, 4
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, api.cfg.vocab, (B, S + T),
                                         dtype=np.int32)).cuda()
    cap = cache_capacity(api.cfg, S + T)
    out = []
    with torch.inference_mode():
        logits, caches = api.prefill(params, {"tokens": toks[:, :S]}, cap)
        for t in range(S, S + T):
            ref, _ = api.prefill(params, {"tokens": toks[:, :t + 1]}, cap)
            logits, caches = api.decode_step(params, caches, toks[:, t], t)
            check(bool(torch.isfinite(logits).all()),
                  f"decode step {t}: non-finite logits")
            out.append((float((logits - ref).abs().max()),
                        torch.allclose(logits, ref, atol=0.08, rtol=0.08)))
    torch.cuda.synchronize()
    return out


def sensitivity(torch, api, params, tokens: int = 256) -> list[float]:
    """How the random-weight model amplifies a rounding-sized difference:
    f32 copies of the weights, the input embeddings of 1 x ``tokens``
    perturbed by 1e-6 (relative), and after each layer the relative change
    of the last token's hidden state."""
    import dataclasses

    from repro_torch.models import lm

    cfg = dataclasses.replace(api.cfg, compute_dtype=torch.float32)

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [f32(v) for v in tree]
        return tree.float()

    w = f32(params)
    gen = torch.Generator("cuda").manual_seed(3)
    toks = torch.randint(1, cfg.vocab, (1, tokens), device="cuda",
                         generator=gen)
    pos = torch.arange(tokens, dtype=torch.int32, device="cuda")[None]
    growth = []
    with torch.inference_mode():
        a = lm.embed_tokens(w, cfg, toks)
        b = a * (1 + 1e-6 * torch.randn(a.shape, device="cuda",
                                        generator=gen))
        for bp in w["blocks"]:
            a, _ = lm._apply_attn_block(bp, cfg, a, pos, None)
            b, _ = lm._apply_attn_block(bp, cfg, b, pos, None)
            growth.append(float((a[:, -1] - b[:, -1]).norm()
                                / a[:, -1].norm()))
    return growth


def serve_check(torch, np, api, params) -> dict:
    """Decode against prefill at full width.  Gated on the first 2 layers:
    the random-weight model amplifies a rounding-sized difference about
    tenfold a layer (``sensitivity``), and decode and prefill round
    differently in their matrix products (2 rows against 2000), so at full
    depth the two part whatever the attention computes; the full depth is
    recorded, not gated."""
    import dataclasses

    from repro_torch.models import build_model

    cut = dataclasses.replace(api.cfg, n_layers=2)
    cut_params = dict(params, blocks=params["blocks"][:2])
    gated = decode_vs_prefill(torch, np, build_model(cut, device="cuda"),
                              cut_params)
    for i, (err, ok) in enumerate(gated):
        check(ok, f"serve-check step {1000 + i}: decode logits max |diff| "
              f"{err} from the prefill's (tolerance 0.08), 2 layers")
    full = decode_vs_prefill(torch, np, api, params)
    out = {"layers_gated": 2, "max_diff_gated": [e for e, _ in gated],
           "layers_full": api.cfg.n_layers,
           "max_diff_full": [e for e, _ in full],
           "within_full": [ok for _, ok in full],
           "sensitivity_f32_per_layer": sensitivity(torch, api, params)}
    print(f"[serve-check] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------------
# Phase 7: timing and bounds
# ---------------------------------------------------------------------------------

def event_ms(torch, fn, reps: int = 15, inner: int = 40) -> float:
    """Median over reps of the CUDA-event time of `inner` calls, per call."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def profiled_kernel_ms(torch, fn, kernel: str, calls: int = 40):
    """Device time per launch of `kernel` from torch.profiler, or None where
    the profiler records no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    return total / count / 1e3 if count and total > 0 else None


def bound_ms(n_bytes: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rates(flops: float, b_ms: float, ms: float, kernel_ms) -> dict:
    """The function's operations over the kernel's time in TFLOP/s, and
    the share of the bound it reaches: by the device time a launch where
    the profiler gave one, else by the time a call."""
    t = kernel_ms or ms
    return {"tflops": flops / t / 1e9, "bound_share": b_ms / t}


def timing_phase(torch, np, dev, errs, launches, plans) -> list[dict]:
    from repro_torch.core.topology import RTX4090_SERVER as spec
    from repro_torch.kernels import topo_score as ts

    req = ts.TopoRequest(2, 2, 1, alpha=0.5)
    rows = []
    per_kernel = {
        # name: (reference function, its line, CUDA kernel symbol, bytes
        #        per lane, f32 operations per lane, main-path shape)
        "topo_score_argmax": ("topo_score_argmax_pallas", 214,
                              "topo_score_argmax_kernel", 28, 4, 256),
        "topo_score": ("topo_score_pallas", 178, "topo_score_kernel", 20, 4,
                       256),
        "placement_tier": ("placement_tier_pallas", 285,
                           "placement_tier_kernel", 12, 0, 1024),
    }
    for name, (ref_fn, ref_line, sym, bpl, fpl, main_n) in per_kernel.items():
        shapes = []
        for n in sorted({main_n, *SIZES}):
            g, c, p, k, ok = lanes(torch, np, spec, n, seed=n, dev=dev)
            if name == "topo_score_argmax":
                def fn(): return ts.topo_score_argmax(g, c, p, k, spec, req, ok=ok)
                def plain(): return ts.topo_score_argmax_plain(g, c, p, k, spec, req, ok=ok)
                extra = 16 * -(-n // ts.TILE)   # per-tile outputs
            elif name == "topo_score":
                def fn(): return ts.topo_score(g, c, p, spec, req)
                def plain(): return ts.topo_score_plain(g, c, p, spec, req)
                extra = 0
            else:
                def fn(): return ts.placement_tier(g, c, spec, req)
                def plain(): return ts.placement_tier_plain(g, c, spec, req)
                extra = 0
            b_ms, b_by = bound_ms(bpl * n + extra, fpl * n)
            ms = event_ms(torch, fn)
            kernel_ms = profiled_kernel_ms(torch, fn, sym)
            shapes.append({
                "n": n, "ms": ms, "kernel_ms": kernel_ms,
                "plain_ms": event_ms(torch, plain), "bound_ms": b_ms,
                "bound_by": b_by, **rates(fpl * n, b_ms, ms, kernel_ms)})
        main = next(s for s in shapes if s["n"] == main_n)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topo_score.cu",
            "replaces": f"src/repro/kernels/topo_score.py:{ref_line}",
            "replaces_fn": ref_fn,
            "launches": launches[name], "on_main_path": launches[name] > 0,
            "launches_per_plan": launches[name] / plans,
            "max_abs_err": errs[name], "shape": [main_n],
            "ms": main["ms"], "kernel_ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "tflops": main["tflops"],
            "bound_share": main["bound_share"], "library_ms": None,
            "shapes": shapes,
        })
    return rows


def flash_timing(torch, shape, plain: bool) -> dict:
    """Kernel, plain version and library call at one shape (bf16, causal):
    the operations the causal mask leaves, the bytes of q, k, v read once
    and the output written once."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, H, K, S, _, d = shape[:6]
    q, k, v = flash_inputs(torch, shape, torch.bfloat16, seed=99)

    def fn(): return fa.flash_attention(q, k, v, causal=True)
    def plain_fn(): return fa.flash_attention_plain(q, k, v, causal=True)
    def library(): return F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    ke, ve = (t.repeat_interleave(H // K, dim=1) for t in (k, v))
    def library_expanded(): return F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True)

    flops = 4 * d * B * H * S * (S + 1) / 2
    n_bytes = 2 * (2 * B * H * S * d + 2 * B * K * S * d)
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOP_PER_S)
    ms = event_ms(torch, fn, inner=20)
    kernel_ms = profiled_kernel_ms(torch, fn, "flash_bf16_kernel")
    return {
        "shape": list(shape[:6]), "ms": ms, "kernel_ms": kernel_ms,
        "plain_ms": (event_ms(torch, plain_fn, reps=5, inner=5) if plain
                     else None),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
        "bytes": n_bytes, **rates(flops, b_ms, ms, kernel_ms),
        "library_ms": event_ms(torch, library, reps=10, inner=10),
        "library_kv_expanded_ms": event_ms(torch, library_expanded, reps=10,
                                           inner=10)}


def flash_row(torch, errs, launches) -> dict:
    main = flash_timing(torch, MAIN_FLASH, plain=True)
    wide = flash_timing(torch, FLASH_SHAPES[6], plain=False)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "replaces_fn": "flash_attention",
        "launches": launches, "on_main_path": launches > 0,
        "max_abs_err": errs["bfloat16"], "max_abs_err_f32": errs["float32"],
        "shape": main["shape"], "dtype": "bfloat16",
        "ms": main["ms"], "kernel_ms": main["kernel_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "tflops": main["tflops"],
        "bound_share": main["bound_share"], "library_ms": main["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)",
        "library_kv_expanded_ms": main["library_kv_expanded_ms"],
        "shapes": [main, wide],
    }


def trace_phase(torch, dev) -> dict:
    """Where one ``imp_pallas`` plan's time goes on the 1024-node cluster:
    the device time of its kernels and copies (torch.profiler) against the
    plan's sourcing wall time, and the host functions that take the most
    of an untraced plan (cProfile)."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import SimConfig, build_saturated_cluster
    from repro_torch.core.workload import table3_workloads
    from repro_torch.kernels import topo_score as ts

    wl = {w.name: w for w in table3_workloads()}["B"]
    cluster = build_saturated_cluster(SimConfig(num_nodes=1024, seed=0,
                                                device=dev))
    sched = TopoScheduler(cluster, engine="imp_pallas")
    untraced_us = [sched.plan(wl).decision.sourcing_us for _ in range(3)]
    calls = ts.flextopo_imp_pallas.calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_us = sched.plan(wl).decision.sourcing_us
        torch.cuda.synchronize()
    filtered = ts.flextopo_imp_pallas.calls - calls
    device = {"kernel": 0.0, "copy": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        part = ("kernel" if "topo_score_argmax_kernel" in ev.key
                else "copy" if "memcpy" in ev.key.lower() else "other")
        device[part] += ev.device_time_total
    prof_host = cProfile.Profile()
    prof_host.enable()
    sched.plan(wl)
    prof_host.disable()
    stats = pstats.Stats(prof_host)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
    out = {
        "nodes": 1024, "preemptor": "B", "filtered_nodes": filtered,
        "sourcing_us_untraced": untraced_us, "sourcing_us_traced": traced_us,
        "device_us": device,
        "device_busy_share": sum(device.values()) / traced_us,
        "host_top_tottime_s": [
            [f"{os.path.basename(f)}:{line}({fn})", calls_, round(tt, 6)]
            for (f, line, fn), (_, calls_, tt, _, _) in top],
    }
    print(f"[trace] {json.dumps(out)}", flush=True)
    return out


def build_all() -> None:
    """Build every CUDA source, one nvcc process each, all started together;
    then count the Hopper instructions of the bf16 flash-attention kernels."""
    from repro_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        log = _build.build(name)
        return name, time.perf_counter() - t0, log

    names = ("topo_score", "flash_attention")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, secs, log in pool.map(one, names):
            print(f"[build] {name}.cu: {secs:.2f} s\n{log.strip()}",
                  flush=True)
    counts = sass_counts(_build._target("flash_attention")[1])
    print(f"[build] flash_bf16_kernel SASS (head dim: counts): "
          f"{json.dumps(counts)}", flush=True)
    check(len(counts) == 4, f"flash_bf16_kernel: {len(counts)} of 4 head "
          "dims found in the SASS")
    for d, c in counts.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
              f"flash_bf16_kernel<{d}> has no wgmma or no TMA load: {c}")


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG")


def sass_counts(lib) -> dict[str, dict[str, int]]:
    """Per bf16 flash kernel (by head dim), the count of each SASS_OPS
    instruction in ``cuobjdump -sass`` of the built library."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts: dict[str, dict[str, int]] = {}
    cur = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_bf16_kernelILi(\d+)E", line)
            cur = counts.setdefault(m.group(1), dict.fromkeys(SASS_OPS, 0)) \
                if m else None
        elif cur is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    cur[op] += 1
    return counts


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # full f32 products in the plain versions, and bf16 products that sum
    # in f32 throughout (no bf16 split-K reductions), as the reference's
    # XLA dots do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    dev = "cuda"
    smi = nvidia_smi()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    build_all()

    errs = kernel_phase(torch, np, dev)
    runs, launches = main_path(dev)
    plans = sum(r["cycles"] * r["scaleups"] for r in runs
                if r["engine"] == "imp_pallas")
    flash_errs = flash_phase(torch)
    serve, api, params = serve_phase(torch, np)
    serve_trace(torch, api, params)
    check_errs = serve_check(torch, np, api, params)
    del api, params
    torch.cuda.empty_cache()
    rows = timing_phase(torch, np, dev, errs, launches, plans)
    rows.append(flash_row(torch, flash_errs,
                          serve["counts"]["flash_attention"]))
    trace_phase(torch, dev)
    p50 = {f"{r['engine']}@{r['nodes']}": r["sourcing_p50_us"] for r in runs}
    print(json.dumps({"sourcing_p50_us": p50,
                      "serve": {k: serve[k] for k in (
                          "prefill_s", "decode_p50_ms", "decode_p90_ms",
                          "tok_per_s", "max_memory_allocated")},
                      "serve_check": check_errs, "card": smi}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run this script "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    try:
        return run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
