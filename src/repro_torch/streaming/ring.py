"""Activation ring: the streaming data plane between the device actors
and the server learner, as ``repro.streaming.ring``.

Device actors *append* activation shards; the server learner *consumes*
them as they commit.  One :class:`ActivationRing` is a sequence of
segments (one shard each) with a bounded in-flight window between
producer and consumer:

* **CRC'd header, committed last**: a segment is a fixed header — magic,
  ring version, client id, sample count, simulated arrival time, cut
  depth (the split layer the activations were made at; -1 untagged),
  payload length, payload CRC32 and a CRC32 over the header itself —
  followed by the payload.  A segment is trusted only when both CRCs
  verify; a torn write (a crash, or one injected through
  :meth:`~repro_torch.transport.faults.FaultPlan.torn_write` under the
  key ``ring/<name>/<seq>``) fails the check right after the commit and
  the producer rewrites the segment (``stats["torn_repairs"]``), so a
  half-landed shard is never read.
* **Backpressure with hysteresis**: at most ``capacity_segments``
  committed-but-unacknowledged segments are in flight.  When the window
  fills the put gate *closes* (``put`` blocks, ``try_put`` returns
  ``False``) and reopens only once the consumer has acknowledged down to
  ``low_watermark``.
* **Two backends, the same bytes**: ``"memmap"`` writes segment ``seq``
  to ``<dir>/seg_<seq>.bin`` (a temp file, fsync'd, renamed into place)
  and decodes its arrays as zero-copy, read-only views onto an
  ``np.memmap``, so the consumed segments stay on disk as the pool;
  ``"memory"`` keeps the same serialized bytes in RAM.
* **Versions**: every segment carries a producer-suppliable version
  (its sequence number by default).

The segment bytes are the reference's: the same header layout
(``ARS2``), the same shard codec and, under one fault plan, the same
truncation.  One producer and one consumer: the blocking ``put`` /
``next_committed(block=True)`` pair serves a producer thread against a
consumer thread; ``try_put`` / ``ack`` serve the single-process
simulator's seeded interleaving
(:class:`~repro_torch.streaming.store.StreamingActivationStore`).

Stdlib and numpy only (no torch).
"""

from __future__ import annotations

import os
import queue
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.observability import NULL_OBS
from repro_torch.transport.framing import crc32

MAGIC = b"ARS2"
# magic(4) | version u64 | client i64 | n_samples u64 | t_arrival f64
# | cut i64 | payload_len u64 | payload_crc u32 | header_crc u32
_HEADER = struct.Struct(">4sQqQdqQII")
HEADER_SIZE = _HEADER.size


class TornSegment(Exception):
    """A segment exists but cannot be trusted (torn write, CRC mismatch)."""


class RingClosed(Exception):
    """A put after ``close()``."""


# ---------------------------------------------------------------------------
# shard <-> bytes (deterministic: no timestamps, no pickling)
# ---------------------------------------------------------------------------


def encode_shard(shard: Dict[str, np.ndarray]) -> bytes:
    """A dict of numpy arrays as deterministic bytes, in key order: the
    key count, then per array its key, dtype string, shape and raw
    C-order bytes."""
    out = [struct.pack(">I", len(shard))]
    for key in shard:
        arr = np.ascontiguousarray(np.asarray(shard[key]))
        kb = key.encode()
        db = arr.dtype.str.encode()
        out.append(struct.pack(">HH", len(kb), len(db)))
        out.append(kb)
        out.append(db)
        out.append(struct.pack(">I", arr.ndim))
        out.append(struct.pack(f">{arr.ndim}q", *arr.shape))
        out.append(arr.tobytes())
    return b"".join(out)


def decode_shard(buf, offset: int = 0) -> Dict[str, np.ndarray]:
    """Inverse of :func:`encode_shard`.  ``buf`` is ``bytes`` or a uint8
    ``np.memmap``; the arrays are zero-copy, read-only views onto it, so
    a caller that needs a tensor or a writable array copies first."""
    mv = memoryview(buf)
    (n,) = struct.unpack_from(">I", mv, offset)
    offset += 4
    shard: Dict[str, np.ndarray] = {}
    for _ in range(n):
        klen, dlen = struct.unpack_from(">HH", mv, offset)
        offset += 4
        key = bytes(mv[offset:offset + klen]).decode()
        offset += klen
        dtype = np.dtype(bytes(mv[offset:offset + dlen]).decode())
        offset += dlen
        (ndim,) = struct.unpack_from(">I", mv, offset)
        offset += 4
        shape = struct.unpack_from(f">{ndim}q", mv, offset)
        offset += 8 * ndim
        count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
        shard[key] = np.frombuffer(buf, dtype=dtype, count=count,
                                   offset=offset).reshape(shape)
        offset += count * dtype.itemsize
    return shard


# ---------------------------------------------------------------------------
# segment header
# ---------------------------------------------------------------------------


class SegmentMeta:
    """The trusted header of one committed segment."""

    __slots__ = ("seq", "version", "client", "n_samples", "t_arrival",
                 "cut", "payload_len")

    def __init__(self, seq, version, client, n_samples, t_arrival, cut,
                 payload_len):
        self.seq = seq
        self.version = version
        self.client = client
        self.n_samples = n_samples
        self.t_arrival = t_arrival
        self.cut = cut              # split depth; -1 = untagged
        self.payload_len = payload_len


def _pack_header(version: int, client: int, n_samples: int,
                 t_arrival: float, cut: int, payload: bytes) -> bytes:
    body = _HEADER.pack(MAGIC, version, client, n_samples, t_arrival, cut,
                        len(payload), crc32(payload), 0)[:-4]
    return body + struct.pack(">I", crc32(body))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


class ActivationRing:
    """Bounded producer/consumer window over an append-only segment log."""

    def __init__(self, directory: Optional[str] = None, *,
                 capacity_segments: int = 64,
                 low_watermark: Optional[int] = None,
                 backend: str = "memmap", fault_plan=None, obs=None,
                 name: str = "acts"):
        if backend not in ("memmap", "memory"):
            raise ValueError(f"backend={backend!r} not in "
                             "('memmap', 'memory')")
        if backend == "memmap" and not directory:
            raise ValueError("memmap backend needs a directory")
        if capacity_segments < 2:
            raise ValueError(f"capacity_segments={capacity_segments} < 2")
        self.dir = directory
        self.backend = backend
        self.capacity = int(capacity_segments)
        self.low_watermark = (self.capacity // 2 if low_watermark is None
                              else int(low_watermark))
        if not 0 <= self.low_watermark < self.capacity:
            raise ValueError(f"low_watermark={self.low_watermark} outside "
                             f"[0, {self.capacity})")
        self.fault_plan = fault_plan
        self.obs = obs if obs is not None else NULL_OBS
        self.name = name
        self._mem_segments: List[Optional[bytes]] = []   # memory backend
        self._metas: List[SegmentMeta] = []              # committed headers
        self._cond = threading.Condition()
        self._committed = 0         # segments with a trusted header
        self._acked = 0             # segments the consumer released
        self._gate_open = True      # watermark hysteresis
        self._closed = False
        self.stats = {"segments": 0, "payload_bytes": 0, "stalls": 0,
                      "stall_wait_s": 0.0, "torn_repairs": 0,
                      "max_occupancy": 0}
        if backend == "memmap":
            os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return self._committed - self._acked

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"seg_{seq:06d}.bin")

    def _store_blob(self, seq: int, blob: bytes):
        """Land ``blob`` as segment ``seq``: in RAM, or through a temp file
        (fsync'd) renamed into place."""
        if self.backend == "memory":
            while len(self._mem_segments) <= seq:
                self._mem_segments.append(None)
            self._mem_segments[seq] = blob
            return
        tmp = self._seg_path(seq) + ".w"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._seg_path(seq))

    def _write_segment(self, seq: int, header: bytes, payload: bytes):
        """Write the segment; an injected torn write truncates it at the
        fault plan's fraction (never past one byte short of whole)."""
        blob = header + payload
        frac = (self.fault_plan.torn_write(f"ring/{self.name}/{seq}")
                if self.fault_plan is not None else None)
        if frac is not None:
            blob = blob[:max(HEADER_SIZE, int(len(blob) * frac))]
            if len(blob) >= HEADER_SIZE + len(payload):
                blob = blob[:HEADER_SIZE + len(payload) - 1]
        self._store_blob(seq, blob)

    def _read_blob(self, seq: int):
        if self.backend == "memory":
            blob = self._mem_segments[seq]
            if blob is None:
                raise TornSegment(f"segment {seq} released or missing")
            return blob
        try:
            return np.memmap(self._seg_path(seq), dtype=np.uint8, mode="r")
        except (FileNotFoundError, ValueError) as e:
            raise TornSegment(f"segment {seq}: {e}") from e

    def _verify(self, seq: int) -> SegmentMeta:
        """Decode and CRC-check segment ``seq``'s header and payload."""
        blob = self._read_blob(seq)
        if len(blob) < HEADER_SIZE:
            raise TornSegment(f"segment {seq}: short header "
                              f"({len(blob)} bytes)")
        head = bytes(memoryview(blob)[:HEADER_SIZE])
        magic, version, client, n_samples, t_arr, cut, plen, pcrc, hcrc = \
            _HEADER.unpack(head)
        if magic != MAGIC:
            raise TornSegment(f"segment {seq}: bad magic {magic!r}")
        if crc32(head[:-4]) != hcrc:
            raise TornSegment(f"segment {seq}: header CRC mismatch")
        if len(blob) < HEADER_SIZE + plen:
            raise TornSegment(f"segment {seq}: payload truncated "
                              f"({len(blob) - HEADER_SIZE}/{plen} bytes)")
        payload = memoryview(blob)[HEADER_SIZE:HEADER_SIZE + plen]
        if crc32(bytes(payload)) != pcrc:
            raise TornSegment(f"segment {seq}: payload CRC mismatch")
        return SegmentMeta(seq, version, client, n_samples, t_arr, cut, plen)

    def try_put(self, client: int, shard: Dict[str, np.ndarray], *,
                version: Optional[int] = None, t_arrival: float = 0.0,
                n_samples: Optional[int] = None, cut: int = -1) -> bool:
        """Commit one shard as the next segment; ``False`` (a stall) when
        the gate is closed.  Never blocks."""
        with self._cond:
            if self._closed:
                raise RingClosed("put after close()")
            if self.occupancy >= self.capacity:
                self._gate_open = False
            if not self._gate_open:
                self.stats["stalls"] += 1
                return False
            seq = self._committed
        if n_samples is None:
            n_samples = len(next(iter(shard.values())))
        ver = seq if version is None else int(version)
        payload = encode_shard(shard)
        header = _pack_header(ver, int(client), int(n_samples),
                              float(t_arrival), int(cut), payload)
        self._write_segment(seq, header, payload)
        # verify after the commit: a tear fails the CRC here and the
        # segment is rewritten whole before a consumer can see it
        try:
            meta = self._verify(seq)
        except TornSegment:
            self.stats["torn_repairs"] += 1
            self.obs.tracer.instant("ring.torn_repair", track="streaming",
                                    ring=self.name, seq=seq)
            self._store_blob(seq, header + payload)
            meta = self._verify(seq)
        with self._cond:
            self._metas.append(meta)
            self._committed = seq + 1
            self.stats["segments"] += 1
            self.stats["payload_bytes"] += len(payload)
            self.stats["max_occupancy"] = max(self.stats["max_occupancy"],
                                              self.occupancy)
            self._cond.notify_all()
        if self.obs.enabled:
            self.obs.metrics.gauge("ring_occupancy", self.occupancy,
                                   ring=self.name)
            self.obs.tracer.instant("ring.commit", track="streaming",
                                    ring=self.name, seq=seq, client=client,
                                    version=ver, occupancy=self.occupancy)
        return True

    def put(self, client: int, shard: Dict[str, np.ndarray], *,
            version: Optional[int] = None, t_arrival: float = 0.0,
            n_samples: Optional[int] = None, cut: int = -1,
            timeout: float = 30.0):
        """Blocking append: waits out backpressure until the consumer has
        drained to the low watermark (``stats["stall_wait_s"]``); raises
        ``TimeoutError`` after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while True:
            if self.try_put(client, shard, version=version,
                            t_arrival=t_arrival, n_samples=n_samples,
                            cut=cut):
                return
            t0 = time.monotonic()
            with self._cond:
                if not self._gate_open and not self._closed:
                    self._cond.wait(timeout=max(0.0, deadline
                                                - time.monotonic()))
            self.stats["stall_wait_s"] += time.monotonic() - t0
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"ring {self.name!r}: put blocked > {timeout}s "
                    f"(occupancy {self.occupancy}/{self.capacity})")

    def close(self):
        """The producer is done; blocked consumers wake and see the end."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # consumer side
    # ------------------------------------------------------------------
    def peek_committed(self) -> int:
        with self._cond:
            return self._committed

    def next_committed(self, seq: int, *, block: bool = False,
                       timeout: float = 30.0) -> bool:
        """Is segment ``seq`` committed?  With ``block=True`` waits until it
        commits or the ring closes (``False`` at the end)."""
        with self._cond:
            if not block:
                return seq < self._committed
            deadline = time.monotonic() + timeout
            while seq >= self._committed and not self._closed:
                if not self._cond.wait(timeout=max(
                        0.0, deadline - time.monotonic())):
                    raise TimeoutError(f"ring {self.name!r}: waited > "
                                       f"{timeout}s for segment {seq}")
            return seq < self._committed

    def read(self, seq: int) -> Tuple[SegmentMeta, Dict[str, np.ndarray]]:
        """Decode committed segment ``seq`` (its header already trusted)."""
        with self._cond:
            if seq >= self._committed:
                raise IndexError(f"segment {seq} not committed "
                                 f"(committed={self._committed})")
            meta = self._metas[seq]
        return meta, decode_shard(self._read_blob(seq), HEADER_SIZE)

    def ack(self, seq: int):
        """Release segment ``seq`` from the in-flight window (flow control
        only: memmap segments stay on disk as the pool, memory segments
        live on through the views decoded from them)."""
        with self._cond:
            if seq != self._acked:
                raise ValueError(f"out-of-order ack: {seq} != {self._acked}")
            self._acked = seq + 1
            if not self._gate_open and self.occupancy <= self.low_watermark:
                self._gate_open = True
                self._cond.notify_all()
        if self.obs.enabled:
            self.obs.metrics.gauge("ring_occupancy", self.occupancy,
                                   ring=self.name)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def metas(self) -> List[SegmentMeta]:
        with self._cond:
            return list(self._metas)


class SegmentPrefetcher:
    """Double-buffered segment reader: a background thread decodes segment
    k + 1 while the consumer works on k.  Yields ``(meta, shard)`` in
    commit order until the ring closes; an error of the reader is raised
    to the consumer."""

    _DONE = object()

    def __init__(self, ring: ActivationRing, start_seq: int = 0,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None

        def run():
            try:
                seq = start_seq
                while ring.next_committed(seq, block=True):
                    self._q.put(ring.read(seq))
                    seq += 1
            except BaseException as e:      # raised to the consumer
                self._error = e
            finally:
                self._q.put(self._DONE)

        threading.Thread(target=run, daemon=True).start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item
