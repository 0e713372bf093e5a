"""Multi-client round engine, as ``repro.fleet.engine.FleetEngine``.

The engine uploads the whole population's samples ONCE as a flat
device-resident pool (:func:`repro_torch.data.pipeline.client_pool`) when
it fits ``run.device_pool_budget_mb``, and every round gathers the
cohort's batches on the device from a (K, H, b) index matrix; a pool over
the budget stays on the host and each round uploads its cohort's stacked
batches, gathered from the clients' own arrays (the same draws).  A round
is :func:`repro_torch.core.steps.make_device_round_step`: a loop over the
K cohort clients (the reference vmaps them; the hand-written kernels have
no batching rule), zero-weight slots padding a partial cohort.

Batch indices are *stateless*: client c's round-r batch comes from
``default_rng((seed, r, c))`` (a buffered aggregation's from ``(seed, r,
slot, c)``), so a run resumed from its checkpoint replays the same
batches, and :meth:`FleetEngine.sequential_round` sees the same data as
:meth:`FleetEngine.run_round`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation, steps
from repro_torch.data.pipeline import ClientData, client_pool
from repro_torch.device import resolve_device


class FleetEngine:
    """Cohort trainer over a fixed client population."""

    def __init__(self, model, run_cfg, clients: List[ClientData], *,
                 device=None):
        self.model = model
        self.run = run_cfg
        self.clients = clients
        self.device = resolve_device(device)
        self.seed = run_cfg.fed.seed
        self.client_sizes = np.asarray([len(c) for c in clients])
        self.offsets = np.cumsum([0] + [len(c) for c in clients])[:-1]
        self.pool_bytes = sum(a.nbytes for c in clients
                              for a in c.dataset.arrays.values())
        # a population over the budget stays on the host: each round's
        # batches are gathered from the clients' own arrays (no
        # concatenated copy is ever built)
        self.resident = self.pool_bytes <= \
            run_cfg.device_pool_budget_mb * 2 ** 20
        self.pool = None
        if self.resident:
            pool_np, _ = client_pool(clients)
            self.pool = {k: torch.as_tensor(v, device=self.device)
                         for k, v in pool_np.items()}
            del pool_np
        self._round = steps.make_device_round_step(model, run_cfg)
        self._client_round = steps.make_client_round_fn(model, run_cfg)
        self._buffered = steps.make_buffered_round_step(model, run_cfg)

    # ------------------------------------------------------------------
    def _indices(self, seeds) -> np.ndarray:
        """(K, H, b) global pool indices, client ``c``'s from
        ``default_rng(seed_key)`` for each ``(seed_key, c)`` of ``seeds``."""
        fed = self.run.fed
        H, b = fed.local_steps, fed.device_batch_size
        idx = np.empty((len(seeds), H, b), np.int32)
        for j, (key, c) in enumerate(seeds):
            rng = np.random.default_rng(key)
            idx[j] = self.offsets[c] + rng.integers(
                0, self.client_sizes[c], (H, b))
        return idx

    def round_indices(self, round_idx: int, client_ids: Sequence[int]
                      ) -> np.ndarray:
        """(K, H, b) global pool indices for one round — stateless in
        (seed, round, client), so resumed runs replay identical batches."""
        return self._indices([((self.seed, round_idx, c), c)
                              for c in (int(c) for c in client_ids)])

    def buffered_round_indices(self, round_idx: int,
                               client_ids: Sequence[int]) -> np.ndarray:
        """(K, H, b) pool indices for one buffered aggregation, seeded by
        (seed, round, slot, client): an async cohort may hold one device
        twice (completed, re-dispatched, completed again before the buffer
        filled), and the slot keeps those two updates on distinct
        batches."""
        return self._indices([((self.seed, round_idx, j, c), c)
                              for j, c in enumerate(int(c)
                                                    for c in client_ids)])

    def _client_batches(self, idx_row: np.ndarray, c: int) -> dict:
        """(H, b, ...) host batches for client ``c`` from its own arrays
        (``idx_row`` holds global pool indices)."""
        local = idx_row - self.offsets[c]
        return {k: v[local] for k, v in
                self.clients[c].dataset.arrays.items()}

    def _batches(self, idx: np.ndarray, ids) -> dict:
        """The cohort's (K, H, b, ...) batches on the device: gathered
        from the resident pool, or stacked on the host and uploaded."""
        if self.resident:
            idx_t = torch.as_tensor(idx, dtype=torch.long,
                                    device=self.device)
            return {k: v[idx_t] for k, v in self.pool.items()}
        per = [self._client_batches(idx[j], c) for j, c in enumerate(ids)]
        return {k: torch.as_tensor(np.stack([p[k] for p in per]),
                                   device=self.device) for k in per[0]}

    # ------------------------------------------------------------------
    def run_round(self, state, round_idx: int, client_ids, weights, lr,
                  pad_to: Optional[int] = None):
        """One synchronous cohort round, a partial cohort padded with
        zero-weight slots to ``pad_to``: ``(new_state, metrics)``."""
        ids = [int(c) for c in client_ids]
        ids, w = aggregation.pad_cohort(
            ids, weights, len(ids) if pad_to is None else pad_to)
        batches = self._batches(self.round_indices(round_idx, ids), ids)
        return self._round(state, batches, w, lr)

    # ------------------------------------------------------------------
    # buffered semi-synchronous (FedBuff) path
    # ------------------------------------------------------------------
    def run_buffered_round(self, state, snapshots, round_idx: int,
                           client_ids, weights, lr):
        """One buffered aggregation: each client trains from its own
        stale snapshot (a list of ring versions, each entry a reference),
        and the staleness-weighted deltas fold into the current global
        ``state``, which is left intact (past versions stay live for
        still-in-flight clients)."""
        ids = [int(c) for c in client_ids]
        return self._buffered(
            state, snapshots,
            self._batches(self.buffered_round_indices(round_idx, ids), ids),
            weights, lr)

    def sequential_round(self, state, round_idx: int, client_ids, weights,
                         lr):
        """Reference implementation of :meth:`run_round`: one client round
        each, then host-level FedAvg (fp64 weights) and the fp64 weighted
        loss — the same batch indices and client round function."""
        ids = [int(c) for c in client_ids]
        idx = self.round_indices(round_idx, ids)
        dev_list, aux_list, losses = [], [], []
        for j, c in enumerate(ids):
            batches = {k: v[0] for k, v in
                       self._batches(idx[j:j + 1], [c]).items()}
            dev, aux, loss = self._client_round(state["device"],
                                                state["aux"], batches, lr)
            dev_list.append(dev)
            aux_list.append(aux)
            losses.append(float(loss))
        w = np.asarray(weights, np.float64)
        with torch.no_grad():
            new_state = {"device": aggregation.fedavg(dev_list, w),
                         "aux": aggregation.fedavg(aux_list, w)}
        wn = w / max(w.sum(), 1e-12)
        loss = float(np.sum(np.asarray(losses, np.float32) * wn))
        return new_state, {"loss": torch.tensor(loss, dtype=torch.float32)}
