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

Two upload paths, as the reference's: ``add`` stores synchronously, and
``start_writer`` / ``submit`` / ``finish`` hand shards to a writer thread
through a queue of ``queue_depth`` (64) shards, so a producer that
outruns the writer blocks (backpressure) and the next shard is computed
while the last is stored; both store in call order.  ``submit`` takes
host arrays (a torch tensor is copied to the host synchronously first,
so the thread never reads device memory that the next batch may reuse),
and an exception in the thread is raised again by ``finish`` (or the
next ``submit``), never dropped.

``pool`` keeps an int8 payload quantized, with its ``acts_scale``, for
the device-resident server phase, whose step dequantizes each batch
(``runtime.compression.dequantize_int8``).
``batches`` streams shuffled host batches of the whole pool from the
same permutation :meth:`ActivationStore.epoch_indices` draws, for the
server phase's over-budget fallback; an int8 payload stays quantized
there too.

Heterogeneous cuts: a shard may carry a *cut depth* tag (the layer its
activations were made at).  The tags live in an index parallel to the
shards, so the payloads are those of the untagged path, and ``pool``,
``num_samples`` and ``epoch_indices`` take ``cut=`` to address one depth's
bucket: shards of different depths never share a pool.  Disk shards keep
no tag (:func:`load_store` rebuilds an untagged store), as in the
reference.

``streaming_batches`` trains while receiving: it yields epochs over
whatever has landed so far, then, once ``finish`` has joined the writer
(the ``_closed`` event), one last full epoch over the complete pool.  The
ring-backed drop-in is
:class:`~repro_torch.streaming.store.StreamingActivationStore`.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np


class ActivationStore:
    def __init__(self, directory: Optional[str] = None,
                 quantize_int8: bool = False, seed: int = 0,
                 queue_depth: int = 64):
        self.dir = directory
        self.quantize = quantize_int8
        self.rng = np.random.default_rng(seed)
        self._mem: Dict[int, List[dict]] = {}
        # the cut depth of each shard, parallel to _mem (None = untagged)
        self._cut_tags: Dict[int, List[Optional[int]]] = {}
        self._lock = threading.Lock()
        # bounded: a producer outrunning the writer blocks on put()
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._closed = threading.Event()
        self.bytes_received = 0
        if directory:
            os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    # receive & store
    # ------------------------------------------------------------------
    def start_writer(self):
        """Start the writer thread (non-daemon: ``finish`` joins it, so it
        never races interpreter teardown mid-write)."""
        if self._writer is None:
            self._error = None
            self._writer = threading.Thread(target=self._writer_loop,
                                            daemon=False)
            self._writer.start()

    def _writer_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            if self._error is not None:
                continue        # drain, so a blocked producer moves on
            try:
                self._store(*item)
            except BaseException as err:    # raised again by finish()
                self._error = err

    def submit(self, client_id: int, shard: dict,
               cut: Optional[int] = None):
        """Queue one shard for the writer thread (after
        :meth:`start_writer`).  Its arrays must be host arrays the caller
        does not write again; a torch tensor is copied to the host here,
        synchronously.  Raises the writer's error, if it has one."""
        if self._writer is None:
            raise RuntimeError("ActivationStore.submit before start_writer")
        if self._error is not None:
            self.finish()           # joins the writer and raises its error
        shard = {k: (v.detach().to("cpu", copy=True).numpy()
                     if hasattr(v, "detach") else v)
                 for k, v in shard.items()}
        self._q.put((client_id, shard, cut))

    def finish(self):
        """Join the writer thread after every queued shard is stored, mark
        the store closed, and raise the exception the writer stopped on,
        if any."""
        if self._writer is not None:
            self._q.put(None)
            self._writer.join()
            self._writer = None
        self._closed.set()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def add(self, client_id: int, shard: dict, cut: Optional[int] = None):
        """Store one uploaded shard (synchronously), tagged with the cut
        depth it was made at when ``cut`` is given."""
        self._store(client_id, shard, cut)

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

    def _store(self, client_id: int, shard: dict,
               cut: Optional[int] = None):
        shard, nbytes = self.prepare_shard(shard, self.quantize)
        assert nbytes == self.shard_nbytes(shard, self.quantize)
        with self._lock:
            lst = self._mem.setdefault(int(client_id), [])
            lst.append(shard)
            self._cut_tags.setdefault(int(client_id), []).append(
                None if cut is None else int(cut))
            self.bytes_received += nbytes
            i = len(lst) - 1
        if self.dir:
            tmp = os.path.join(self.dir, f".tmp_{client_id}_{i}.npz")
            final = os.path.join(self.dir, f"client_{client_id}_{i}.npz")
            np.savez(tmp, **shard)
            os.replace(tmp, final)

    # ------------------------------------------------------------------
    # load for training
    # ------------------------------------------------------------------
    def _shards(self, client_id: Optional[int] = None,
                cut: Optional[int] = None) -> List[dict]:
        """The shards of every client (or one), in client insertion order,
        all of them or those of one cut bucket: a snapshot taken under the
        lock, so a reader may run beside the writer thread."""
        with self._lock:
            cids = list(self._mem) if client_id is None \
                else [int(client_id)]
            if cut is None:
                return [s for c in cids for s in self._mem.get(c, [])]
            return [s for c in cids
                    for s, t in zip(self._mem.get(c, []),
                                    self._cut_tags.get(c, []))
                    if t == cut]

    def cut_depths(self) -> List[int]:
        """The distinct cut tags present, sorted (untagged shards not)."""
        return sorted({t for tags in self._cut_tags.values()
                       for t in tags if t is not None})

    def pool(self, client_id: Optional[int] = None,
             cut: Optional[int] = None) -> dict:
        """The consolidated (or one client's, or one cut bucket's) pool as
        one dict of arrays, in client insertion order, as the reference
        lays it out; an int8 payload stays quantized, with its
        ``acts_scale``."""
        shards = self._shards(client_id, cut)
        if not shards:
            return {}
        return {k: np.concatenate([s[k] for s in shards])
                for k in shards[0]}

    def pool_nbytes(self, client_id: Optional[int] = None) -> int:
        """Bytes the (quantized) pool occupies, summed per shard (no
        copy): the device-memory admission check of the server phase."""
        return sum(np.asarray(v).nbytes
                   for s in self._shards(client_id) for v in s.values())

    def num_samples(self, client_id: Optional[int] = None,
                    cut: Optional[int] = None) -> int:
        return sum(len(s["acts"]) for s in self._shards(client_id, cut))

    def clients(self) -> List[int]:
        return sorted(self._mem)

    def epoch_indices(self, batch_size: int,
                      client_id: Optional[int] = None,
                      cut: Optional[int] = None) -> np.ndarray:
        """(nb, batch_size) int32 gather indices for one shuffled epoch:
        one ``rng.permutation``, trailing remainder dropped.  With ``cut=``
        they index that bucket's pool; a caller draws the buckets in
        sorted-depth order, so the rng stream is deterministic."""
        n = self.num_samples(client_id, cut)
        order = self.rng.permutation(n)
        nb = n // batch_size
        return order[:nb * batch_size].reshape(nb, batch_size).astype(np.int32)

    def _one_epoch(self, pool: dict, batch_size: int):
        """One shuffled pass over ``pool``: one ``rng.permutation``,
        trailing remainder dropped, the draw :meth:`epoch_indices` makes."""
        order = self.rng.permutation(len(pool["acts"]))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            yield {k: v[order[s:s + batch_size]] for k, v in pool.items()}

    def batches(self, batch_size: int, epochs: int = 1):
        """Shuffled batches of the whole pool for ``epochs`` passes."""
        pool = self.pool()
        if not pool:
            return
        for _ in range(epochs):
            yield from self._one_epoch(pool, batch_size)

    def streaming_batches(self, batch_size: int, poll: float = 0.01):
        """Train while receiving: epochs over the pool landed so far until
        the store is closed, then one full epoch over the complete pool,
        so a shard that landed after the last mid-stream snapshot is seen
        at least once."""
        while not self._closed.is_set():
            pool = self.pool()
            if len(pool.get("acts", ())) >= batch_size:
                yield from self._one_epoch(pool, batch_size)
            else:
                time.sleep(poll)
        # finish() joins the writer before it sets _closed: this snapshot
        # is the final pool
        pool = self.pool()
        if len(pool.get("acts", ())) >= batch_size:
            yield from self._one_epoch(pool, batch_size)


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
        st._cut_tags.setdefault(client_id, []).append(None)
    return st
