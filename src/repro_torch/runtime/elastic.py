"""Elastic cohort sizing, as ``repro.runtime.elastic.ElasticCohort``.

The federated phase's cohort size is a per-round knob: the aggregation is
weight-renormalized, so rounds tolerate any K' <= K (client churn,
scale-up mid-training).  :class:`ElasticCohort` grows or shrinks it from
measured round times.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ElasticCohort:
    min_clients: int
    max_clients: int
    current: int

    def adjust(self, round_time: float, target_time: float):
        """Grow when rounds are fast (spare capacity), shrink when slow."""
        if round_time < 0.8 * target_time and self.current < self.max_clients:
            self.current = min(self.max_clients, self.current * 2)
        elif round_time > 1.25 * target_time and self.current > self.min_clients:
            self.current = max(self.min_clients, self.current // 2)
        return self.current
