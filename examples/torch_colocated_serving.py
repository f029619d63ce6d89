"""End-to-end driver on the PyTorch/CUDA port (the paper's kind: SERVING):
co-located LLM serving through the event-driven day cycle.

The same walkthrough as ``examples/colocated_serving.py``.  A 12-node
cluster runs the paper's §1/§2.3 scenario on the co-location event loop
(`repro_torch.core.colocation`): diurnal online traffic scales a chat
service up and down, offline batch jobs pad the valleys, the morning ramp
preempts offline victims (which re-enter the pending queue and are
replanned), and every committed decision streams into a per-hour report.
The topology-aware leg plans with the fused ``imp_batched`` engine over
the device-resident cluster state, on the card unless ``--device cpu``,
against the topology-unaware ``godel``.

The same day then runs through the two-level backfill ladder
(`repro_torch.serving.elastic`): valley ticks pack pending offline jobs
into online replicas' spare request slots before spinning whole offline
instances, and peak ramps reverse the ladder.

Last, the smoke config of a model (``--arch``, llama3.2-1b by default, as
the reference example) serves real batched requests through the port's
``ServeEngine``, and the Fig. 2 factor of each placement tier converts its
measured decode throughput into scheduled performance.

    python examples/torch_colocated_serving.py [--device cuda|cpu]
                                               [--arch llama3.2-1b]
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.colocation import (ColocationConfig,  # noqa: E402
                                         compare_day_cycle, compare_two_level,
                                         default_policies)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import TIER_PERF, Request, ServeEngine  # noqa: E402

AWARE = "imp_batched"


def ab_lines(ab: dict) -> list[str]:
    """The A/B's lines: one per engine, then the uplifts."""
    lines = []
    for name, rep in ab["reports"].items():
        lines.append(
            f"  {name:6} scheduled-perf {rep.scheduled_perf:7.1f} "
            f"GPU-h | hit rate {rep.hit_rate:.0%} over "
            f"{rep.preemptions} preemptions | requeue "
            f"{rep.requeue_replanned}/{rep.requeued} replanned | "
            f"offline goodput {rep.offline_goodput:.0f} GPU-h")
    lines.append(
        f"  scheduled-performance uplift: {ab['uplift'] * 100:+.1f}% "
        f"(preemptor slice {ab['preemptor_uplift'] * 100:+.1f}%; the "
        f"paper reports +55%)")
    return lines


def two_level_lines(two: dict) -> list[str]:
    """The two-level ladder's lines: one per mode, then the delta."""
    lines = []
    for name, rep in two["reports"].items():
        extra = (f" | request-level adm {rep.elastic_admitted} "
                 f"demote {rep.elastic_demoted} "
                 f"done {rep.elastic_completed}"
                 if name == "two_level" else "")
        lines.append(
            f"  {name:13} offline goodput {rep.offline_goodput:7.1f} "
            f"GPU-h | SLO attainment {rep.slo_attainment:.3f} | "
            f"{rep.preemptions} preemptions, {rep.requeued} victims"
            f"{extra}")
    lines.append(
        f"  ramps absorbed at request granularity: "
        f"{two['preemption_delta']:+d} preemptions, every victim requeue "
        f"avoided (goodput {two['goodput_uplift'] * 100:+.1f}% on this "
        f"small unsaturated day; the committed saturated protocol above "
        f"is the gated number)")
    return lines


def serve_tiers(arch: str, device: str) -> float:
    """Decode tok/s of ``arch``'s smoke config through ``ServeEngine`` (a
    warm-up batch excluded), printed times each tier's Fig. 2 factor."""
    cfg_m = get_config(arch, smoke=True)
    api = build_model(cfg_m, device=device)
    params = api.init(0)
    rng = np.random.default_rng(0)

    def batch():
        return [Request(rid=i,
                        prompt=rng.integers(1, cfg_m.vocab, 12,
                                            dtype=np.int32),
                        max_new_tokens=8) for i in range(4)]

    engine = ServeEngine(api, params, batch_size=2, seq_len=32)
    engine.run(batch())                     # warm-up (kernel builds), excluded
    t0 = time.perf_counter()
    engine.run(batch())
    dt = time.perf_counter() - t0
    raw_tps = engine.stats["tokens"] / 2 / dt   # stats span both runs
    print("decode throughput x Fig. 2 factor per placement tier:")
    for tier in sorted(TIER_PERF):
        factor = TIER_PERF[tier]
        print(f"  tier {tier}: {raw_tps:6.1f} tok/s raw x {factor:.2f} = "
              f"{raw_tps * factor:6.1f} tok/s scheduled")
    return raw_tps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="llama3.2-1b")
    args = ap.parse_args(argv)

    # ---- the simulated day: topology-aware vs topology-unaware A/B -------
    cfg = ColocationConfig(num_nodes=12, seed=0, horizon_hours=24.0,
                           device=args.device)
    print(f"simulating a {cfg.horizon_hours:.0f}h day on {cfg.num_nodes} "
          f"nodes (Table 3 mix, policies: "
          f"{[p.workload.name for p in default_policies(cfg)]}) ...")
    ab = compare_day_cycle(cfg, engines=(AWARE, "godel"))
    print("\n".join(ab_lines(ab)))

    # ---- the two-level backfill ladder on the same seeded day -------------
    bench = Path(__file__).parent.parent / "BENCH_elastic.json"
    if bench.exists():
        b = json.loads(bench.read_text())
        io_b, tl_b = b["modes"]["instance_only"], b["modes"]["two_level"]
        print(f"\ncommitted two-level A/B ({b['num_nodes']} nodes, "
              f"BENCH_elastic.json): offline goodput "
              f"{b['goodput_uplift'] * 100:+.1f}%, SLO attainment "
              f"{tl_b['slo_attainment']:.3f} vs {io_b['slo_attainment']:.3f}, "
              f"preemptions {io_b['preemptions']} -> {tl_b['preemptions']}")
    print("two-level request+instance ladder on this day:")
    two = compare_two_level(cfg)
    print("\n".join(two_level_lines(two)))

    # ---- serve real tokens at the day's achieved placement tiers ----------
    aware = ab["reports"][AWARE]
    ramp = max(aware.hours, key=lambda r: r.preemptions)
    print(f"\nbusiest ramp hour {ramp.hour:.0f}: {ramp.preemptions} "
          f"preemptions, {ramp.requeued} victims requeued, "
          f"mean decision factor {ramp.decision_factor_mean:.2f}")
    tps = serve_tiers(args.arch, args.device)
    return {"ab": ab, "two_level": two, "raw_tok_per_s": tps}


if __name__ == "__main__":
    main()
