"""Activation consolidation store (Ampere §3.2.3), in-memory and fp32.

The consolidated pool 𝒜: client activation shards are stored as they
arrive, and the server phase samples batches across all clients.  This is
the in-memory, non-quantized path of ``repro.data.activation_store``
(disk shards, int8 payloads, cut tags and the writer thread are later
slices); its rng contract is the same — one ``permutation`` per epoch,
trailing remainder dropped — so a store seeded identically yields the
same batch order as the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class ActivationStore:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._mem: Dict[int, List[dict]] = {}

    def add(self, client_id: int, shard: dict):
        """Store one shard: the payload becomes fp32, other keys ride along."""
        shard = dict(shard)
        shard["acts"] = np.asarray(shard["acts"]).astype(np.float32)
        self._mem.setdefault(int(client_id), []).append(shard)

    def _shards(self) -> List[dict]:
        return [s for lst in self._mem.values() for s in lst]

    def pool(self) -> dict:
        """The consolidated pool as one dict of arrays (client insertion
        order, as the JAX store lays it out)."""
        shards = self._shards()
        if not shards:
            return {}
        return {k: np.concatenate([s[k] for s in shards])
                for k in shards[0]}

    def num_samples(self) -> int:
        return sum(len(s["acts"]) for s in self._shards())

    def epoch_indices(self, batch_size: int) -> np.ndarray:
        """(nb, batch_size) int32 gather indices for one shuffled epoch."""
        n = self.num_samples()
        order = self.rng.permutation(n)
        nb = n // batch_size
        return order[:nb * batch_size].reshape(nb, batch_size).astype(np.int32)
