"""Fig. 2 tier-performance model — the single source of truth.

The paper's Fig. 2 maps a placement tier (NUMA-local / same-socket /
cross-socket) to a relative scheduled-performance multiplier.  One copy
serves the scheduler side and the serving side, so that they cannot drift
apart; `repro_torch.serving.engine` re-exports it.
"""
from __future__ import annotations

from .placement import min_tier_for

# Paper Fig. 2: relative communication cost per placement tier converted to a
# scheduled-performance multiplier (NUMA-local = 1.0, same-socket, cross-socket).
TIER_PERF = {0: 1.0, 1: 10 / 12, 2: 10 / 32}


def scheduled_factor(decision) -> float:
    """Fig. 2 performance multiplier for a committed `SchedulingDecision`.

    Raw engine throughput times this factor gives the paper's "scheduled
    performance" of the instance at its placement tier.  Rejected decisions
    (no placement) score 0.
    """
    if decision.placement is None:
        return 0.0
    return TIER_PERF[decision.placement.tier]


def relative_scheduled_factor(spec, tier: int, need_gpus: int) -> float:
    """Fig. 2 factor normalized by the best tier ``need_gpus`` can
    physically achieve on the SKU.

    A full-node instance necessarily spans sockets and serves at 1.0 when
    it does, while a small instance misplaced across sockets is charged the
    full cross-socket/NUMA-local cost ratio — so degradation measures
    scheduling quality, not instance size.  This is the per-instance rate
    the co-location day cycle integrates into its scheduled-performance
    metric and the rate the elastic layer's `SLOMonitor` predicts
    interference against.
    """
    return TIER_PERF.get(tier, 0.0) / TIER_PERF[min_tier_for(spec, need_gpus)]
