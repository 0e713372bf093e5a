"""The round journal and the heartbeats of the federated loop, as
``repro.runtime.fault_tolerance``.

:class:`RoundJournal` is a write-ahead journal of round boundaries so a
restarted coordinator knows where it stopped (used together with the
:class:`~repro_torch.runtime.checkpoint.Checkpointer`).  Records carry a
CRC so a torn or bit-flipped line is rejected, never resumed from.
:class:`Heartbeats` tracks when each simulated device was last seen (the
fleet scheduler's liveness filter).  Retries come with the transport
slice.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

import numpy as np


def crc32(data: bytes, value: int = 0) -> int:
    """CRC-32 of ``data`` as an unsigned int (the transport framing's)."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def _canonical(record: dict) -> bytes:
    """Canonical JSON bytes a journal record's CRC is computed over."""
    return json.dumps(record, sort_keys=True,
                      separators=(",", ":")).encode()


class RoundJournal:
    """Append-only JSONL journal; the last complete *verified* record wins.

    Every appended record gains a ``_crc`` field (CRC32 over the
    canonical JSON of the record without it).  ``last()`` only trusts
    records whose CRC verifies — a line that merely parses as JSON (a
    tear can keep it syntactically valid) is not enough to resume from.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, record: dict):
        rec = dict(record)
        rec["_crc"] = crc32(_canonical(record))
        created = not os.path.exists(self.path)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if created:
            # fsync the parent directory so the journal file's very
            # existence survives a crash right after creation
            try:
                dfd = os.open(os.path.dirname(self.path) or ".",
                              os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass

    def last(self) -> Optional[dict]:
        if not os.path.exists(self.path):
            return None
        last = None
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # torn write (a crash mid-append); valid records may
                    # follow it after a restart, so keep scanning
                    continue
                if not isinstance(rec, dict):
                    continue
                crc = rec.pop("_crc", None)
                if crc is None or crc != crc32(_canonical(rec)):
                    # unverifiable: a line without a CRC, or a tear that
                    # left syntactically valid JSON behind
                    continue
                last = rec
        return last


class Heartbeats:
    """Tracks last-seen times per client; ``alive()`` filters a cohort.

    ``now`` is required: every caller runs inside the simulated fleet and
    passes sim time, so no wall clock can enter a replayed schedule.
    """

    def __init__(self, timeout: float = 60.0):
        self.timeout = timeout
        self.last_seen = {}

    def beat(self, client_id: int, now: float):
        self.last_seen[int(client_id)] = now

    def alive(self, client_ids, now: float):
        out = []
        for c in client_ids:
            t = self.last_seen.get(int(c))
            if t is None or now - t <= self.timeout:
                out.append(c)
        return np.asarray(out, dtype=np.int64)
