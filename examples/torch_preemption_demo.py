"""The paper's Fig. 3 walkthrough on the PyTorch/CUDA port: three 4090
servers, workloads A/B/C co-located at saturation, then a topology-aware
scale-up of A.

The same walkthrough and lines as ``examples/preemption_demo.py``: the
failure mode of priority-only preemption (``godel``: victims freed on the
wrong socket) against topology-aware preemption, which here runs the fused
``imp_batched`` engine over the cluster's device-resident state (on the
card unless ``--device cpu``).
Then the transactional API: ``sched.plan(wl)`` returns a ``Transaction``
over a copy-on-write view, ``txn.commit()`` applies it and
``txn.rollback()`` restores the exact prior state; ``sched.plan_batch``
plans several scale-ups against one snapshot; ``@register_engine`` plugs a
custom victim-sourcing engine into the registry.

    python examples/torch_preemption_demo.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.core import (Cluster, RTX4090_SERVER, TopoScheduler,  # noqa
                              register_engine, registered_engines,
                              table1_workloads)
from repro_torch.core.preemption import flextopo_imp  # noqa: E402


def gpu_map(cluster, node):
    topo = cluster.topos[node]
    cells = []
    for g in range(8):
        owner = topo.graph.nodes[("gpu", g)]["used_by"]
        cells.append((owner or "....")[:6].ljust(6))
    return " ".join(cells[:4]) + " | " + " ".join(cells[4:])


def show(cluster, title):
    print(f"\n== {title} ==")
    print("          socket 0                    | socket 1")
    for n in range(cluster.num_nodes):
        print(f"machine {n + 1}: {gpu_map(cluster, n)}")


def saturated(engine, device):
    wls = {w.name: w for w in table1_workloads()}
    cluster = Cluster(RTX4090_SERVER, 3, device=device)
    sched = TopoScheduler(cluster, engine=engine)
    sched.schedule(wls["A"])
    for _ in range(6):
        sched.schedule(wls["B"])
    for _ in range(8):
        sched.schedule(wls["C"])
    return cluster, sched, wls


# A custom engine is one decorated sourcing function: here, plain IMP
# restricted to even node INDICES — machines 1 and 3, say a maintenance
# policy that fences off the rest.
@register_engine("imp_even_nodes")
def imp_even_nodes(cluster, workload, node):
    return flextopo_imp(cluster, workload, node) if node % 2 == 0 else []


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args(argv).device
    aware = "imp_batched"

    for engine in ("godel", aware):
        cluster, sched, wls = saturated(engine, dev)
        show(cluster, f"saturated cluster (engine={engine})")

        # two-phase: plan (pure read) ... then commit
        txn = sched.plan(wls["A"])
        dec = txn.decision
        print(f"\nscale-up A with engine={engine}: planned "
              f"{dec.kind} on machine {dec.node + 1}, victims={dec.victims}")
        txn.commit()
        print(f"  committed: evicted {[v.name for v in dec.evicted]}")
        print(f"  placement tier={dec.placement.tier} "
              f"({['NUMA', 'socket', 'cross-socket'][dec.placement.tier]}) "
              f"topology hit={dec.hit}")
        show(cluster, f"after preemption (engine={engine})")

        # rollback restores the exact pre-commit state (same victim uids)
        txn.rollback()
        show(cluster, f"after rollback (engine={engine})")
        print("-" * 70)

    # batched admission: plan 3 scale-ups against one snapshot, commit together
    cluster, sched, wls = saturated(aware, dev)
    txns = sched.plan_batch([wls["B"], wls["B"], wls["A"]])
    print("\nplan_batch against one snapshot:",
          [(t.decision.kind, t.decision.node + 1) for t in txns])
    for t in txns:
        t.commit()
    show(cluster, "after committing the batch")

    # the registry knows every engine, including custom ones
    print("\nregistered engines:", ", ".join(registered_engines()))
    cluster, sched, wls = saturated("imp_even_nodes", dev)
    dec = sched.preempt(wls["B"])
    print(f"custom engine chose machine {dec.node + 1} "
          f"(even node indices only), hit={dec.hit}")


if __name__ == "__main__":
    main()
