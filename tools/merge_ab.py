#!/usr/bin/env python3
"""K2's split form and the sharded merges, one checkout against another, on
one card.

    python3 tools/merge_ab.py DIR [DIR ...]
    python3 tools/merge_ab.py --sourcing DIR [DIR ...]

Each DIR is a checkout of this repository.  Its ``src/repro_torch`` runs in a
process of its own, one after the other in the order given (pass parent,
change, change, parent to interleave them); this checkout's
``chip_smoke.py`` makes the states (``resident_state``: RTX 4090 servers,
preemptor B's request).  Each process builds its kernels, then times:

* K2 (``normal_cycle_kernel``, and ``normal_merge_kernel`` where the
  checkout still has it) a call, one cluster and split, at
  ``chip_smoke.SWEEP_NODES``: device time from torch.profiler, every
  kernel of the call summed;
* over 4 shards of a 10240-row state on the one card, the sharded normal
  cycle (``preemption_device._normal``) and the sharded sweep and tail
  (``_sweep_tail``): the device time a call of each kernel instance and
  its launches a call, and the wall time a call to its end (host and
  device);
* with ``--sourcing`` instead, ``TopoScheduler.plan()`` of preemptor B with
  ``imp_sharded`` over 4 shards of the card on the saturated 10240-node
  cluster (``build_saturated_cluster``, seed 0, about 3 minutes to build):
  ``sourcing_us`` of 60 plans after 10 warm-up plans, P50 and P90.

It prints one JSON line a run, with the card's name and power limit.
Without CUDA, or copied alone, it exits 2 with no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.core import cluster_parallel as cp
from repro_torch.core import preemption_device as pd
from repro_torch.core.topology import RTX4090_SERVER as spec
from repro_torch.kernels import _build
from repro_torch.kernels import fused_class as fc
from repro_torch.kernels import normal_cycle as nck
from torch.profiler import ProfilerActivity, profile


def device_us(fn, names, calls=50):
    """Device time a call of fn of each kernel instance whose name holds
    one of names, in us, with its launches a call (the profiler is asked
    again where it saw none)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = {}
        for ev in prof.key_averages():
            if any(k in ev.key for k in names):
                us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
                got[ev.key.split("(")[0].replace("void ", "")] = [
                    us / calls, ev.count / calls]
        if got:
            return got
    return None


def wall_us(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


_build.build("topo_score")
dev = torch.device("cuda", torch.cuda.current_device())
req = fc.FusedRequest(1000, 2, 2, 1, 0.5)
out = {}
if sys.argv[2] == "sourcing":
    from repro_torch.core.scheduler import TopoScheduler
    from repro_torch.core.simulator import SimConfig, build_saturated_cluster
    from repro_torch.core.workload import table3_workloads
    wl = {w.name: w for w in table3_workloads()}["B"]
    t0 = time.perf_counter()
    cluster = build_saturated_cluster(SimConfig(num_nodes=10240, seed=0,
                                                device="cuda"))
    out["build_s"] = time.perf_counter() - t0
    cluster.device_state(mesh=(dev,) * 4)
    sched = TopoScheduler(cluster, engine="imp_sharded", alpha=0.5)
    for _ in range(10):
        sched.plan(wl)
    us = [sched.plan(wl).decision.sourcing_us for _ in range(60)]
    out["sourcing_imp_sharded_10240x4"] = [float(np.percentile(us, 50)),
                                           float(np.percentile(us, 90))]
else:
    k2 = ("normal_cycle_kernel", "normal_merge_kernel")
    empty = (torch.zeros(0, dtype=torch.int32, device=dev),
             torch.zeros((0, 87), dtype=torch.int32, device=dev))
    rows = []
    for n in cs.SWEEP_NODES:
        ns, v, dr = (torch.from_numpy(x).to(dev)
                     for x in cs.resident_state(np, spec, n, 8, n))
        st = fc.launch_state(ns, v, dr, *empty, None, resident=True)
        most = fc.max_cluster_ctas(st.device)
        row = {"nodes": n}
        for form, cut in (("one_cluster", n), ("split", 0)):
            g = nck.normal_geometry(n, most, split_nodes=cut)
            got = device_us(lambda: nck.launch(st, req, spec, geometry=g), k2)
            row[form] = {"geometry": list(g), "kernels_us": got,
                         "us": sum(t for t, _ in got.values()) if got
                         else None}
        rows.append(row)
    out["k2"] = rows
    ns, v, dr = cs.resident_state(np, spec, 10240, 8, 10240)
    shards = cp._shards_of(cp.Mesh((dev,) * 4), ns, v, dr)
    pidx = [empty[0]] * 4
    pbuf = [empty[1]] * 4
    calls = {
        "normal": (lambda: pd._normal(shards, pidx, pbuf, req, spec), k2),
        "sweep_tail": (lambda: pd._sweep_tail(
            shards, pidx, pbuf, pidx, req, spec, m_res=8, resident=True,
            m_gather=8), ("fused_class_kernel", "fused_argmax_kernel",
                          "tail_merge_kernel"))}
    for name, (fn, names) in calls.items():
        out[f"sharded_{name}_10240x4"] = {
            "kernels_us": device_us(fn, names), "wall_us": wall_us(fn)}
print(json.dumps(out), flush=True)
'''


def smi() -> str:
    got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 else ""


def main(argv: list[str]) -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mode = "sourcing" if argv[:1] == ["--sourcing"] else "kernels"
    dirs = argv[1:] if mode == "sourcing" else argv
    if (not torch.cuda.is_available() or not dirs
            or not os.path.isfile(os.path.join(here, "chip_smoke.py"))):
        print(__doc__, file=sys.stderr)
        return 2
    card = smi()
    for i, root in enumerate(dirs):
        src = os.path.join(os.path.abspath(root), "src")
        if not os.path.isdir(os.path.join(src, "repro_torch")):
            print(f"merge_ab: {src}/repro_torch not found", file=sys.stderr)
            return 2
        got = subprocess.run([sys.executable, "-c", CHILD, here, mode],
                             cwd=root, env={**os.environ, "PYTHONPATH": src},
                             capture_output=True, text=True, timeout=900)
        if got.returncode != 0:
            print(got.stdout + got.stderr, file=sys.stderr)
            return 1
        row = json.loads(got.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": root, "mode": mode,
                          "card": card, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
