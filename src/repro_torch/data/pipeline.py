"""Batching for the federated device phase (numpy-side; tensors are made
at the step boundary).

* :class:`ClientData` — one client's shard with an infinite shuffled batch
  stream.
* :func:`federate` — dataset -> Dirichlet-partitioned list of ClientData.
* :func:`round_batches` — stack (K, H, b, ...) arrays for one round.
* :func:`client_pool` — flatten all clients into one (N_total, ...) pool
  + per-client offsets; uploaded once, each round gathers its cohort's
  batches on the device from a (K, H, b) index matrix.
* :class:`DevicePrefetcher` — double-buffered host -> device upload of a
  batch stream (the server phase's over-budget fallback).
* :func:`generators_state` / :func:`load_generators_state` — the cohort
  sampler's and every client's batch stream's state, for a checkpoint.

Every function consumes numpy RNG exactly as ``repro.data.pipeline`` does,
so cohorts and batches match the JAX package draw for draw.
"""

from __future__ import annotations

import queue
import threading
from typing import List

import numpy as np
import torch

from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import Dataset


class ClientData:
    def __init__(self, dataset: Dataset, client_id: int, seed: int = 0):
        self.dataset = dataset
        self.client_id = client_id
        self.rng = np.random.default_rng(seed * 100003 + client_id)
        self._order = np.arange(len(dataset))
        self._cursor = len(dataset)  # force shuffle on first use

    def __len__(self):
        return len(self.dataset)

    def next_indices(self, batch_size: int) -> np.ndarray:
        """Dataset-local sample indices of the next shuffled batch."""
        n = len(self.dataset)
        take = []
        need = batch_size
        while need > 0:
            if self._cursor >= n:
                self.rng.shuffle(self._order)
                self._cursor = 0
            got = min(need, n - self._cursor)
            take.append(self._order[self._cursor:self._cursor + got])
            self._cursor += got
            need -= got
        return np.concatenate(take)

    def next_batch(self, batch_size: int) -> dict:
        idx = self.next_indices(batch_size)
        return {k: v[idx] for k, v in self.dataset.arrays.items()}

    def batch_indices(self, batch_size: int, steps: int) -> np.ndarray:
        """(steps, b) dataset-local indices — the index-only twin of
        :meth:`batches`, for feeding a device-resident sample pool."""
        return np.stack([self.next_indices(batch_size)
                         for _ in range(steps)])

    def batches(self, batch_size: int, steps: int) -> dict:
        """(steps, b, ...) stacked batches."""
        bs = [self.next_batch(batch_size) for _ in range(steps)]
        return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def federate(dataset: Dataset, num_clients: int, alpha: float,
             seed: int = 0) -> List[ClientData]:
    rng = np.random.default_rng(seed)
    parts = dirichlet_partition(dataset.labels, num_clients, alpha, rng)
    return [ClientData(dataset.subset(ix), k, seed) for k, ix in enumerate(parts)]


def client_pool(clients: List[ClientData]):
    """Concatenate every client's samples into one flat pool.

    Returns ``(pool, offsets)``: ``pool`` is a dict of (N_total, ...)
    arrays, ``offsets[k]`` is client k's first row — a client's local
    index ``i`` lives at global row ``offsets[k] + i``.
    """
    keys = list(clients[0].dataset.arrays)
    pool = {k: np.concatenate([c.dataset.arrays[k] for c in clients])
            for k in keys}
    offsets = np.cumsum([0] + [len(c) for c in clients])[:-1]
    return pool, offsets


def round_batches(clients: List[ClientData], cohort_ids, local_steps: int,
                  batch_size: int) -> dict:
    """(K, H, b, ...) stacked batches for one federated round."""
    per_client = [clients[int(c)].batches(batch_size, local_steps)
                  for c in cohort_ids]
    return {k: np.stack([pc[k] for pc in per_client])
            for k in per_client[0]}


def generators_state(rng: np.random.Generator,
                     clients: List[ClientData]) -> dict:
    """JSON-able state of the cohort sampler ``rng`` and of each client's
    batch stream, which a resumed run must continue from."""
    return {"rng": rng.bit_generator.state,
            "clients": [{"rng": c.rng.bit_generator.state,
                         "order": c._order.tolist(),
                         "cursor": int(c._cursor)} for c in clients]}


def load_generators_state(rng: np.random.Generator,
                          clients: List[ClientData], state: dict):
    """Put back what :func:`generators_state` saved."""
    rng.bit_generator.state = state["rng"]
    for c, s in zip(clients, state["clients"]):
        c.rng.bit_generator.state = s["rng"]
        c._order = np.asarray(s["order"], dtype=c._order.dtype)
        c._cursor = s["cursor"]


class DevicePrefetcher:
    """Double-buffered host -> device prefetch, as
    ``repro.data.pipeline.DevicePrefetcher``: a background thread moves
    each batch (a dict of numpy arrays) to ``device`` up to two batches
    ahead of the consumer, so the upload of batch k + 1 overlaps
    the step on batch k.  On the card the copy leaves pinned memory,
    non-blocking, on a stream of its own, and the consumer's stream waits
    for it.  Yields the device batches in producer order; an error of the
    producer is raised to the consumer."""

    _DONE = object()

    def __init__(self, batches, device):
        self.device = torch.device(device)
        self.q: queue.Queue = queue.Queue(maxsize=2)
        self.error = None
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def put(batch):
            if stream is None:
                return {k: torch.as_tensor(v) for k, v in batch.items()}, None
            with torch.cuda.stream(stream):
                out = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .pin_memory().to(self.device, non_blocking=True)
                       for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(stream)
            return out, done

        def run():
            try:
                for batch in batches:
                    self.q.put(put(batch))
            except BaseException as e:   # raised to the consumer
                self.error = e
            finally:
                self.q.put(self._DONE)

        threading.Thread(target=run, daemon=True).start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                if self.error is not None:
                    raise self.error
                return
            batch, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(done)
                for t in batch.values():    # freed only after the step
                    t.record_stream(consumer)
            yield batch
