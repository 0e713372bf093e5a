"""Non-IID data partitioning (paper §5.1).

Data is partitioned across clients with a Dirichlet distribution
Dir(alpha / (1 - alpha + eps)) over classes: smaller alpha -> more skew,
alpha = 1 -> concentration -> inf -> approximately IID.  ``alpha`` follows
the paper's parameterization exactly, including the eps guard.
"""

from __future__ import annotations

from typing import List

import numpy as np

EPS = 1e-8


def concentration(alpha: float) -> float:
    return alpha / (1.0 - alpha + EPS)


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        rng: np.random.Generator,
                        min_per_client: int = 1) -> List[np.ndarray]:
    """Partition sample indices across clients.

    Per-class Dirichlet split: for each class, a Dirichlet(conc) vector over
    clients decides what fraction of that class each client receives.
    Guarantees every client at least ``min_per_client`` samples by stealing
    from the largest client when necessary.
    """
    conc = concentration(alpha)
    classes = np.unique(labels)
    idx_per_client: List[list] = [[] for _ in range(num_clients)]
    for c in classes:
        idx_c = np.flatnonzero(labels == c)
        rng.shuffle(idx_c)
        props = rng.dirichlet(np.full(num_clients, conc))
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx_c, cuts)):
            idx_per_client[k].extend(part.tolist())

    out = [np.asarray(sorted(ix), dtype=np.int64) for ix in idx_per_client]
    # rescue empty/tiny clients
    for k in range(num_clients):
        while len(out[k]) < min_per_client:
            donor = int(np.argmax([len(o) for o in out]))
            if len(out[donor]) <= min_per_client:
                break
            out[k] = np.append(out[k], out[donor][-1])
            out[donor] = out[donor][:-1]
    for k in range(num_clients):
        rng.shuffle(out[k])
    return out


def class_histogram(labels: np.ndarray, parts: List[np.ndarray],
                    num_classes: int) -> np.ndarray:
    h = np.zeros((len(parts), num_classes), np.int64)
    for k, ix in enumerate(parts):
        for c, n in zip(*np.unique(labels[ix], return_counts=True)):
            h[k, int(c)] = n
    return h


def heterogeneity_index(hist: np.ndarray) -> float:
    """Mean total-variation distance between client label distributions and
    the global distribution (0 = IID)."""
    p_global = hist.sum(0) / max(1, hist.sum())
    p_client = hist / np.maximum(hist.sum(1, keepdims=True), 1)
    return float(np.mean(np.abs(p_client - p_global).sum(1) / 2.0))
