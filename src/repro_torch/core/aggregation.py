"""Model aggregation: weighted FedAvg (Eq. 4/10) and cohort sampling with
the fault-tolerance policy (client dropout, straggler deadlines), as
``repro.core.aggregation``; ``sample_cohort`` consumes numpy RNG exactly
as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.interop import tree_map


def normalize_weights(weights, device="cpu"):
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
    return w / torch.clamp(torch.sum(w), min=1e-12)


def fedavg_stacked(trees, weights):
    """Weighted mean over clients of every leaf; ``trees`` is a list of
    per-client trees (the leading client axis of the JAX version)."""
    def agg(*leaves):
        w = normalize_weights(weights, leaves[0].device)
        stacked = torch.stack([l.float() for l in leaves])
        wf = w.reshape((-1,) + (1,) * (stacked.dim() - 1))
        return torch.sum(stacked * wf, dim=0).to(leaves[0].dtype)
    return tree_map(agg, *trees)


def pad_cohort(client_ids, weights, pad_to: int):
    """Pad a partial cohort to ``pad_to`` slots by repeating the first
    survivor with weight 0 (zero-weight clients don't contribute)."""
    ids = [int(c) for c in client_ids]
    w = [float(x) for x in weights]
    if not ids:
        raise ValueError("cannot pad an empty cohort")
    while len(ids) < pad_to:
        ids.append(ids[0])
        w.append(0.0)
    return ids, w


def sample_cohort(rng: np.random.Generator, fed_cfg, round_idx: int = 0):
    """Sample the participating cohort for one round and apply the
    fault-tolerance policy; returns clients, weights, dropped, times,
    round_time."""
    k = min(fed_cfg.clients_per_round, fed_cfg.num_clients)
    chosen = rng.choice(fed_cfg.num_clients, size=k, replace=False)
    alive = rng.random(k) >= fed_cfg.drop_prob
    groups = np.asarray(fed_cfg.straggler_speed_groups)
    speed = groups[chosen % len(groups)]
    times = 1.0 / speed * (1.0 + 0.05 * rng.random(k))
    if fed_cfg.straggler_deadline_factor > 0:
        deadline = np.median(times) * fed_cfg.straggler_deadline_factor
        alive &= times <= deadline
    if not alive.any():           # never lose the whole round
        alive[np.argmin(times)] = True
    clients = chosen[alive]
    return {
        "clients": clients,
        "weights": np.ones(len(clients), np.float64) / len(clients),
        "dropped": chosen[~alive],
        "times": times[alive],
        "round_time": float(times[alive].max()) if len(clients) else 0.0,
    }

