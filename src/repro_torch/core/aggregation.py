"""Model aggregation: weighted FedAvg (Eq. 4/10), FedBuff's buffered
staleness-weighted delta fold, the prefix FedAvg of heterogeneous-depth
device blocks, and cohort sampling with the fault-tolerance policy
(client dropout, straggler deadlines), as ``repro.core.aggregation``;
``sample_cohort`` consumes numpy RNG exactly as the JAX package does.

The JAX package's "stacked" forms take leaves with a leading client
axis; here that axis is a Python list of per-client trees (the device
round is a loop over the clients), so no K-fold copy of a model is made.
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


def fedavg(trees, weights):
    """Host-level weighted average of a list of parameter trees (fp64
    weights, each product and the sum in fp32)."""
    w = np.asarray(weights, np.float64)
    w = w / max(w.sum(), 1e-12)

    def agg(*leaves):
        acc = sum(float(wi) * l.float() for wi, l in zip(w, leaves))
        return acc.to(leaves[0].dtype)
    return tree_map(agg, *trees)


def staleness_weights(staleness):
    """Normalized polynomial staleness scaling ``1/sqrt(1+s)`` (FedBuff):
    fresher updates weigh more; all-zero staleness is uniform FedAvg."""
    s = np.asarray(staleness, np.float64)
    w = 1.0 / np.sqrt(1.0 + s)
    return w / max(w.sum(), 1e-12)


def fedbuff_stacked(global_tree, trained_k, snapshot_k, weights,
                    server_lr: float = 1.0):
    """Buffered staleness-weighted delta aggregation (FedBuff)::

        new = global + server_lr * sum_i w_i * (trained_i - snapshot_i)

    ``trained_k`` / ``snapshot_k`` are lists of per-client trees (each
    client trained from its own, possibly stale, snapshot); ``weights``
    are the staleness-scaled aggregation weights, normalized here, so a
    zero-weight slot contributes nothing.  With every snapshot equal to
    the current global state this is weighted FedAvg."""
    k = len(trained_k)

    def agg(g, *ts):
        w = normalize_weights(weights, g.device)
        delta = torch.stack([t.float() - s.float()
                             for t, s in zip(ts[:k], ts[k:])])
        wf = w.reshape((-1,) + (1,) * (delta.dim() - 1))
        return (g.float() + server_lr * torch.sum(delta * wf, dim=0)).to(
            g.dtype)
    return tree_map(agg, global_tree, *trained_k, *snapshot_k)


def prefix_fedavg(current, by_depth, weights):
    """Aggregate heterogeneous-depth device blocks over their overlapping
    layer prefix.

    ``current`` is the global device stack (layers ``[0, p_max)`` and any
    non-layer keys, the LM embedding); ``by_depth`` maps a cut depth ``d``
    to a trained device tree whose ``"layers"`` cover ``[0, d)``;
    ``weights`` maps a depth to its bucket's total client weight.  Layer
    ``l`` is the :func:`fedavg` of the positive-weight buckets that own it
    (``d > l``), non-layer keys of every positive-weight bucket; a layer
    no such bucket covers keeps its ``current`` tensors, so a round where
    only shallow-cut clients survive leaves the deep tail as it was."""
    depths = sorted(d for d in by_depth if weights.get(d, 0.0) > 0.0)
    if not depths:
        return current
    layers = []
    for l, cur in enumerate(current["layers"]):
        owners = [d for d in depths if d > l]
        layers.append(fedavg([by_depth[d]["layers"][l] for d in owners],
                             [weights[d] for d in owners])
                      if owners else cur)
    out = {"layers": layers}
    for key in current:
        if key != "layers":
            out[key] = fedavg([by_depth[d][key] for d in depths],
                              [weights[d] for d in depths])
    return out


def tree_sub(a, b):
    """Leaf-wise ``a - b`` in fp32."""
    return tree_map(lambda x, y: x.float() - y.float(), a, b)


def tree_add(a, b, scale=1.0):
    """Leaf-wise ``a + scale * b`` in fp32, cast back to ``a``'s dtype."""
    return tree_map(lambda x, y: (x.float() + scale * y.float()).to(x.dtype),
                    a, b)


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


def survivors(client_ids, weights, kept, excluded):
    """The clients ``kept`` (indices into ``client_ids``) of a round and
    their weights, renormalized over them when the transport excluded any
    (a quorum-degraded round), as every reference trainer does inline."""
    ids = [client_ids[i] for i in kept]
    w = [weights[i] for i in kept]
    if excluded:
        total = sum(w)
        w = [x / total for x in w]
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

