"""Ring-backed activation store: the streaming drop-in for
:class:`~repro_torch.data.activation_store.ActivationStore`, as
``repro.streaming.store``.

Device actors submit prepared shards into an
:class:`~repro_torch.streaming.ring.ActivationRing`; the learner side
drains committed segments into the shard table the plain store builds, so
``pool`` / ``epoch_indices`` / ``batches`` / ``pool_nbytes`` are
inherited unchanged: a streamed run consumes the same pool bytes in the
same order, and its history is the serialized run's.

What changes is the data plane and the clock:

* shards round-trip through CRC'd ring segments (a memmap ring's
  segments stay on disk as the pool's storage: the drained arrays are
  read-only views onto them, and ``pool`` concatenates them into one
  fresh array before anything reaches a tensor), and
* each segment carries its simulated *arrival time*;
  :meth:`sample_arrivals` feeds the
  :class:`~repro_torch.streaming.overlap.OverlapAccountant`, which lets
  server epochs overlap the device round in the accounted ``sim_time``.

In one process the producer and the consumer interleave
deterministically: ``submit`` tries a non-blocking put and, under
backpressure, drains a seeded
:class:`~repro_torch.streaming.overlap.InterleaveSchedule`-sized chunk of
segments itself before it retries, so occupancy and stall statistics
replay exactly for a seed.  Producer and consumer threads use the ring's
blocking surface directly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.data.activation_store import ActivationStore
from repro_torch.observability import NULL_OBS
from repro_torch.streaming.overlap import InterleaveSchedule
from repro_torch.streaming.ring import ActivationRing


class StreamingActivationStore(ActivationStore):
    """An ActivationStore whose receive path is a backpressured ring."""

    def __init__(self, directory: Optional[str] = None,
                 quantize_int8: bool = False, seed: int = 0, *,
                 capacity_segments: int = 64,
                 low_watermark: Optional[int] = None,
                 backend: str = "memmap", drain_chunk: int = 4,
                 interleave_seed: int = 0, fault_plan=None, obs=None):
        # the ring owns the disk: the plain store's .npz copies would write
        # every shard twice
        super().__init__(directory=None, quantize_int8=quantize_int8,
                         seed=seed)
        self.obs = obs if obs is not None else NULL_OBS
        self.ring = ActivationRing(
            directory=directory, capacity_segments=capacity_segments,
            low_watermark=low_watermark, backend=backend,
            fault_plan=fault_plan, obs=self.obs, name="acts")
        self.schedule = InterleaveSchedule(seed=interleave_seed,
                                           drain_chunk=drain_chunk)
        # (n_samples, t_arrival) per drained shard, in pool order
        self.arrivals: List[Tuple[int, float]] = []
        self._next_seq = 0

    # ------------------------------------------------------------------
    # producer side (device actors)
    # ------------------------------------------------------------------
    def start_writer(self):
        """No writer thread: the ring is the asynchronous boundary."""

    def submit(self, client_id: int, shard: dict, t_arrival: float = 0.0,
               cut: Optional[int] = None):
        """Commit one shard (host arrays; a tensor is copied to the host
        first) with its simulated arrival time and cut tag; under
        backpressure drain a seeded chunk of segments and retry."""
        shard = {k: (v.detach().to("cpu", copy=True).numpy()
                     if hasattr(v, "detach") else v)
                 for k, v in shard.items()}
        shard, nbytes = self.prepare_shard(shard, self.quantize)
        assert nbytes == self.shard_nbytes(shard, self.quantize)
        while not self.ring.try_put(int(client_id), shard,
                                    t_arrival=t_arrival,
                                    cut=-1 if cut is None else int(cut)):
            self.drain(self.schedule.next_drain())

    def add(self, client_id: int, shard: dict, cut: Optional[int] = None):
        self.submit(client_id, shard, cut=cut)

    def finish(self):
        """Close the ring, drain every segment left, mark the store
        closed."""
        self.ring.close()
        self.drain()
        self._closed.set()

    # ------------------------------------------------------------------
    # consumer side (server learner)
    # ------------------------------------------------------------------
    def drain(self, max_segments: Optional[int] = None) -> int:
        """Move up to ``max_segments`` committed segments (all when
        ``None``) into the shard table and acknowledge them.  The arrays
        are zero-copy views onto the segments' storage."""
        n = 0
        while ((max_segments is None or n < max_segments)
               and self.ring.next_committed(self._next_seq)):
            meta, shard = self.ring.read(self._next_seq)
            nbytes = sum(np.asarray(v).nbytes for v in shard.values())
            with self._lock:
                self._mem.setdefault(meta.client, []).append(shard)
                self._cut_tags.setdefault(meta.client, []).append(
                    None if meta.cut < 0 else int(meta.cut))
                self.bytes_received += nbytes
                self.arrivals.append((meta.n_samples, meta.t_arrival))
            self.ring.ack(self._next_seq)
            self._next_seq += 1
            n += 1
        return n

    def sample_arrivals(self) -> np.ndarray:
        """Each pool row's simulated arrival time, in the pool's order
        (drain order is submit order)."""
        with self._lock:
            arr = list(self.arrivals)
        if not arr:
            return np.zeros((0,), np.float64)
        return np.repeat(np.asarray([t for _, t in arr], np.float64),
                         [n for n, _ in arr])
