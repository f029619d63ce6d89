"""Candidate scoring — paper Eq. 1 / Eq. 2.

S(C) = alpha * 1/sum_priority(C) + (1 - alpha) * T(C_flextopo)

with T the piecewise tier score (high / medium / low) and C = (node, victim
set).  alpha=0 scores purely by topology, alpha=1 purely by priority.
"""
from __future__ import annotations

import dataclasses

# Piecewise linear tier values for T (paper: high / medium / low).
TIER_SCORES = (1.0, 0.5, 0.1)  # index by tier 0/1/2
DEFAULT_ALPHA = 0.5


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One candidate C = (node, victim set) with its evaluation."""

    node: int
    victims: tuple[int, ...]      # instance uids, sorted
    tier: int                     # achievable topology tier after eviction
    priority_sum: int             # sum of victim priorities

    def topo_score(self) -> float:
        return TIER_SCORES[self.tier] if self.tier < len(TIER_SCORES) else 0.0


def score(candidate: Candidate, alpha: float = DEFAULT_ALPHA) -> float:
    """Paper Eq. 1."""
    prio_term = 1.0 / candidate.priority_sum if candidate.priority_sum > 0 else 1.0
    return alpha * prio_term + (1.0 - alpha) * candidate.topo_score()


def select_best(candidates: list[Candidate], alpha: float = DEFAULT_ALPHA
                ) -> Candidate | None:
    """Paper Eq. 2: argmax_S over all (node, victim-set) candidates.

    Deterministic tie-break: fewer victims, then lower node id, then lexical
    victim uids — so simulations are reproducible.
    """
    if not candidates:
        return None
    return max(
        candidates,
        key=lambda c: (score(c, alpha), -len(c.victims), -c.node, tuple(-v for v in c.victims)),
    )
