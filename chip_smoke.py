#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. The card's name and power limit (``nvidia-smi``), then the build of every
   CUDA source of the path (``nvcc`` for sm_90a, one process per source).
2. Each kernel against its plain PyTorch version on the card, bit for bit
   (tiers, per-tile argmax, scores), over all three server specs, several
   requests with the exactness traps in their inputs, and n in {256, 1500,
   65536}; ``placement_tier`` also against host ``best_tier``.
3. The main path: ``run_hit_rate_experiment`` (the paper's Table 4
   protocol, ``TopoScheduler.plan()`` per scale-up) with ``imp_pallas`` and
   then host ``imp`` on the 100-node Table 3 cluster (2 cycles x 50
   scale-ups, which must give 100/100/0/0) and on a 1024-node cluster
   (1 x 20); the decisions of the two engines must be identical.  Launch
   counters are set to 0 just before each ``imp_pallas`` run and read just
   after it: the topo_score_argmax launches must equal the engine's
   per-node calls less its host fallbacks, and be > 0.  Then the 20-node
   3 x 10 protocol must give 30/30/0.
4. One ``{"kernels": [...]}`` line: per kernel its launches on the main
   path, the largest difference against the plain version, the time per
   call from CUDA events (kernel and plain version), the device time per
   launch from torch.profiler, the bound, and more.  Then a ``[trace]``
   line: one traced ``imp_pallas`` plan on 1024 nodes, its device time
   against its sourcing wall time, and the host functions that dominate.
5. The card's name and power limit again, then the last line
   ``{"ok": true, "device": {...}}``.

With no CUDA device, or without ``src/repro_torch`` beside this file, it
exits with a non-zero code and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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

def reset_counts(ts) -> None:
    for w in ts.WRAPPERS:
        w.launches = 0
    ts.flextopo_imp_pallas.calls = 0
    ts.flextopo_imp_pallas.overflow = 0


def read_counts(ts) -> dict[str, int]:
    out = {w.__name__: w.launches for w in ts.WRAPPERS}
    out["imp_pallas_calls"] = ts.flextopo_imp_pallas.calls
    out["imp_pallas_overflow"] = ts.flextopo_imp_pallas.overflow
    return out


def protocol(ts, num_nodes, cycles, scaleups, engine, dev):
    from repro_torch.core.simulator import SimConfig, run_hit_rate_experiment

    cfg = SimConfig(num_nodes=num_nodes, seed=0, device=dev)
    reset_counts(ts)                      # counts at 0 just before the path
    t0 = time.perf_counter()
    rep = run_hit_rate_experiment(cfg, engine, cycles=cycles,
                                  scaleups_per_cycle=scaleups)
    torch_sync(dev)
    wall = time.perf_counter() - t0
    counts = read_counts(ts)              # and read just after it
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
        fast, s_fast = protocol(ts, nodes, cycles, scaleups, "imp_pallas",
                                dev)
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
        host, s_host = protocol(ts, nodes, cycles, scaleups, "imp", dev)
        check(fast.decision_keys == host.decision_keys,
              f"{nodes} nodes: imp_pallas and imp decisions differ")
        runs.append(s_host)
        print(f"[main] {nodes} nodes: {len(fast.decision_keys)} decisions "
              f"identical between imp_pallas and imp", flush=True)
    return runs, launches


# ---------------------------------------------------------------------------------
# Phase 4: timing and bounds
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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            shapes.append({
                "n": n, "ms": event_ms(torch, fn),
                "kernel_ms": profiled_kernel_ms(torch, fn, sym),
                "plain_ms": event_ms(torch, plain), "bound_ms": b_ms,
                "bound_by": b_by})
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
            "bound_by": main["bound_by"], "library_ms": None,
            "shapes": shapes,
        })
    return rows


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


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = "cuda"
    smi = nvidia_smi()
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    log = _build.build("topo_score")
    print(f"[build] topo_score.cu: {time.perf_counter() - t0:.2f} s\n"
          f"{log.strip()}", flush=True)

    errs = kernel_phase(torch, np, dev)
    runs, launches = main_path(dev)
    plans = sum(r["cycles"] * r["scaleups"] for r in runs
                if r["engine"] == "imp_pallas")
    rows = timing_phase(torch, np, dev, errs, launches, plans)
    trace_phase(torch, dev)
    p50 = {f"{r['engine']}@{r['nodes']}": r["sourcing_p50_us"] for r in runs}
    print(json.dumps({"sourcing_p50_us": p50, "card": smi}), flush=True)
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
