"""Activation consolidation store (Ampere §3.2.3 + Algorithm 1 lines
16-19), as ``repro.data.activation_store``: fp32 payloads, or int8 with
one fp32 scale per row of the last axis (``quantize_int8``, beyond the
paper: the one-shot transfer shrinks 4x), in memory and optionally
persisted as disk shards.

* The consolidated pool 𝒜 across all clients, in client insertion order;
  each client's own pool stays addressable through ``client_id=``.
* ``directory`` — every stored shard is also written to
  ``<dir>/client_<k>_<i>.npz`` (atomic rename); :func:`load_store`
  rebuilds a store from them.
* Accounting — ``bytes_received`` counts the stored bytes exactly as the
  reference does (:meth:`ActivationStore.shard_nbytes`), and the rng
  contract is the same: one ``permutation`` per epoch, trailing remainder
  dropped, so a store seeded identically yields the reference's batch
  order.

``add`` stores synchronously, in call order (the order the reference's
writer thread keeps).  ``pool`` keeps an int8 payload quantized, with its
``acts_scale``, for the device-resident server phase, whose step
dequantizes each batch (``runtime.compression.dequantize_int8``).
``batches`` streams shuffled host batches of the whole pool from the
same permutation :meth:`ActivationStore.epoch_indices` draws, for the
server phase's over-budget fallback; an int8 payload stays quantized
there too.  The writer thread, cut tags and the streaming ring are later slices.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


class ActivationStore:
    def __init__(self, directory: Optional[str] = None,
                 quantize_int8: bool = False, seed: int = 0):
        self.dir = directory
        self.quantize = quantize_int8
        self.rng = np.random.default_rng(seed)
        self._mem: Dict[int, List[dict]] = {}
        self.bytes_received = 0
        if directory:
            os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    # receive & store
    # ------------------------------------------------------------------
    def add(self, client_id: int, shard: dict):
        """Store one uploaded shard (synchronously)."""
        self._store(client_id, shard)

    @staticmethod
    def shard_nbytes(shard: dict, quantize: bool = False) -> int:
        """Stored bytes for ``shard`` under ``quantize``: the payload (fp32,
        or int8 plus one fp32 scale a row) and every other array that
        rides along (the labels)."""
        acts = np.asarray(shard["acts"])
        if quantize:
            nbytes = acts.size + (acts.size // acts.shape[-1]) * 4
        else:
            nbytes = acts.size * 4
        return nbytes + sum(np.asarray(v).nbytes for k, v in shard.items()
                            if k not in ("acts", "acts_scale"))

    @staticmethod
    def prepare_shard(shard: dict, quantize: bool = False):
        """Normalize one shard for storage: an fp32 payload, or int8 and
        its per-row absmax scale (the reference's numpy, so the stored
        arrays are identical).  Returns ``(prepared_shard,
        stored_nbytes)``."""
        shard = dict(shard)
        acts = np.asarray(shard["acts"])
        if quantize:
            scale = np.abs(acts).max(axis=-1, keepdims=True) / 127.0
            scale = np.maximum(scale, 1e-12)
            q = np.clip(np.round(acts / scale), -127, 127).astype(np.int8)
            shard["acts"] = q
            shard["acts_scale"] = scale.astype(np.float32)
            nbytes = q.nbytes + shard["acts_scale"].nbytes
        else:
            shard["acts"] = acts.astype(np.float32)
            nbytes = shard["acts"].nbytes
        nbytes += sum(np.asarray(v).nbytes for k, v in shard.items()
                      if k not in ("acts", "acts_scale"))
        return shard, nbytes

    def _store(self, client_id: int, shard: dict):
        shard, nbytes = self.prepare_shard(shard, self.quantize)
        assert nbytes == self.shard_nbytes(shard, self.quantize)
        lst = self._mem.setdefault(int(client_id), [])
        lst.append(shard)
        self.bytes_received += nbytes
        if self.dir:
            i = len(lst) - 1
            tmp = os.path.join(self.dir, f".tmp_{client_id}_{i}.npz")
            final = os.path.join(self.dir, f"client_{client_id}_{i}.npz")
            np.savez(tmp, **shard)
            os.replace(tmp, final)

    # ------------------------------------------------------------------
    # load for training
    # ------------------------------------------------------------------
    def _shards(self, client_id: Optional[int] = None) -> List[dict]:
        cids = list(self._mem) if client_id is None else [int(client_id)]
        return [s for c in cids for s in self._mem.get(c, [])]

    def pool(self, client_id: Optional[int] = None) -> dict:
        """The consolidated (or one client's) pool as one dict of arrays,
        in client insertion order, as the reference lays it out; an int8
        payload stays quantized, with its ``acts_scale``."""
        shards = self._shards(client_id)
        if not shards:
            return {}
        return {k: np.concatenate([s[k] for s in shards])
                for k in shards[0]}

    def pool_nbytes(self, client_id: Optional[int] = None) -> int:
        """Bytes the (quantized) pool occupies, summed per shard (no
        copy): the device-memory admission check of the server phase."""
        return sum(np.asarray(v).nbytes
                   for s in self._shards(client_id) for v in s.values())

    def num_samples(self, client_id: Optional[int] = None) -> int:
        return sum(len(s["acts"]) for s in self._shards(client_id))

    def clients(self) -> List[int]:
        return sorted(self._mem)

    def epoch_indices(self, batch_size: int,
                      client_id: Optional[int] = None) -> np.ndarray:
        """(nb, batch_size) int32 gather indices for one shuffled epoch:
        one ``rng.permutation``, trailing remainder dropped."""
        n = self.num_samples(client_id)
        order = self.rng.permutation(n)
        nb = n // batch_size
        return order[:nb * batch_size].reshape(nb, batch_size).astype(np.int32)

    def batches(self, batch_size: int, epochs: int = 1):
        """Shuffled batches of the whole pool for ``epochs`` passes: one
        ``rng.permutation`` an epoch, trailing remainder dropped, the draw
        :meth:`epoch_indices` makes."""
        pool = self.pool()
        if not pool:
            return
        n = len(pool["acts"])
        for _ in range(epochs):
            order = self.rng.permutation(n)
            for s in range(0, n - batch_size + 1, batch_size):
                yield {k: v[order[s:s + batch_size]] for k, v in pool.items()}


def load_store(directory: str, seed: int = 0) -> ActivationStore:
    """Rebuild a store from disk shards (the server restart path)."""
    st = ActivationStore(directory=None, seed=seed)
    for fname in sorted(os.listdir(directory)):
        if not fname.startswith("client_") or not fname.endswith(".npz"):
            continue
        client_id = int(fname.split("_")[1])
        with np.load(os.path.join(directory, fname)) as z:
            shard = {k: z[k] for k in z.files}
        st._mem.setdefault(client_id, []).append(shard)
    return st
