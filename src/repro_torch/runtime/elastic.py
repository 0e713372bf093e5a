"""Elastic scaling, as ``repro.runtime.elastic``.

Federated phase: the cohort size is a per-round knob — the aggregation is
weight-renormalized, so rounds tolerate any K' <= K (client churn,
scale-up mid-training).  :class:`ElasticCohort` grows or shrinks it from
measured round times.

Datacenter phase: :func:`remesh_plan` gives the placements that move the
server state to a different ``DeviceMesh`` (e.g. a node was lost);
:func:`remesh` moves it (``distribute_tensor`` for a plain tensor,
``redistribute`` for a ``DTensor`` already on the new mesh, its local
shards gathered first when it lives on another one).  The parameter
specs are mesh-shape-agnostic, so the plan is the rules over the new mesh.
"""

from __future__ import annotations

import dataclasses

from repro_torch.sharding import rules as shard_rules


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


def remesh_plan(params, old_mesh, new_mesh, *, strategy: str = "fsdp_tp"):
    """Placements tree (a list a leaf) that moves ``params`` onto
    ``new_mesh``."""
    specs = shard_rules.param_specs(params, new_mesh, strategy=strategy)
    return shard_rules.to_placements(specs, new_mesh)


def _place(t, placements, mesh):
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        if t.device_mesh == mesh:
            return t.redistribute(mesh, placements)
        t = t.full_tensor()
    return distribute_tensor(t, mesh, placements)


def remesh(params, old_mesh, new_mesh, *, strategy: str = "fsdp_tp"):
    plan = remesh_plan(params, old_mesh, new_mesh, strategy=strategy)

    def walk(p, pl):
        if isinstance(p, dict):
            return {k: walk(v, pl[k]) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, q) for v, q in zip(p, pl))
        return _place(p, pl, new_mesh)
    return walk(params, plan)
