#!/usr/bin/env python3
"""The fused engine's plan latency, one checkout against another, on one card.

    python3 tools/sourcing_ab.py DIR [DIR ...]

Each DIR is a checkout of this repository.  Its ``src/repro_torch`` runs in a
process of its own, one after the other in the order given (pass parent,
change, change, parent to interleave them).  Each process builds its
kernels, then on saturated clusters of 1024 and 10240 RTX 4090 servers
(``build_saturated_cluster``, seed 0) times ``TopoScheduler.plan()`` of
preemptor B with ``imp_batched`` and with ``imp_batched_full`` (pure reads:
``sourcing_us`` of 60 plans after 10 warm-up plans, P50 and P90), then runs
the 24-node and the 1024-node 24 h co-location days (seed 0, the committed
protocol, warm-up on) and takes the plan P50 and P90 of their requests
(``Autoscaler.plan_us``), and the 1024-node day's events/s.  It prints one
JSON line a run, with the card's name and power limit.  Without CUDA, or
copied alone, it exits 2 with no result.
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
from repro_torch.kernels import _build
from repro_torch.core.colocation import (ColocationConfig, ColocationSim,
                                         default_policies)
from repro_torch.core.scheduler import TopoScheduler
from repro_torch.core.simulator import SimConfig, build_saturated_cluster
from repro_torch.core.workload import table3_workloads

_build.build("topo_score")
wl = {w.name: w for w in table3_workloads()}["B"]
out = {}
for n in (1024, 10240):
    cluster = build_saturated_cluster(SimConfig(num_nodes=n, seed=0,
                                                device="cuda"))
    for engine in ("imp_batched", "imp_batched_full"):
        sched = TopoScheduler(cluster, engine=engine)
        for _ in range(10):
            sched.plan(wl)
        us = [sched.plan(wl).decision.sourcing_us for _ in range(60)]
        out[f"sourcing_{engine}_{n}"] = [float(np.percentile(us, 50)),
                                         float(np.percentile(us, 90))]
    del cluster, sched
for n in (24, 1024):
    cfg = ColocationConfig(num_nodes=n, seed=0, device="cuda",
                           engine="imp_batched", warmup=True)
    sim = ColocationSim(cfg, policies=default_policies(cfg))
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    out[f"day{n}_plan_us"] = [float(np.percentile(sim.auto.plan_us, 50)),
                              float(np.percentile(sim.auto.plan_us, 90))]
    out[f"day{n}_events_per_s"] = sim.events_processed / wall
print(json.dumps(out), flush=True)
'''


def smi() -> str:
    got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 else ""


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("sourcing_ab: needs a CUDA device and at least one checkout",
              file=sys.stderr)
        return 2
    card = smi()
    for i, root in enumerate(sys.argv[1:]):
        src = os.path.join(os.path.abspath(root), "src")
        if not os.path.isdir(os.path.join(src, "repro_torch")):
            print(f"sourcing_ab: {src}/repro_torch not found", file=sys.stderr)
            return 2
        got = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                             env={**os.environ, "PYTHONPATH": src},
                             capture_output=True, text=True, timeout=900)
        if got.returncode != 0:
            print(got.stdout + got.stderr, file=sys.stderr)
            return 1
        row = json.loads(got.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": root, "card": card, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
