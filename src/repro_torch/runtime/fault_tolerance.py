"""The round journal, retries and the heartbeats of the federated loop, as
``repro.runtime.fault_tolerance``.

* :class:`RoundJournal` — a write-ahead journal of round boundaries so a
  restarted coordinator knows where it stopped (used together with the
  :class:`~repro_torch.runtime.checkpoint.Checkpointer`).  Records carry a
  CRC so a torn or bit-flipped line is rejected, never resumed from; a
  ``fault_plan`` tears appends on purpose for the chaos runs.
* :func:`with_retries` — bounded retries of flaky host-side work (a thin
  wrapper kept beside :meth:`repro_torch.transport.RetryPolicy.call`).
* :class:`Heartbeats` — when each simulated device was last seen (the
  fleet scheduler's liveness filter).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.transport.framing import crc32


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
    ``fault_plan`` (a :class:`~repro_torch.transport.FaultPlan`) cuts the
    ``n``-th append at the fraction its ``torn_write(f"journal/{n}")``
    draws, as the reference's does.
    """

    def __init__(self, path: str, fault_plan=None):
        self.path = path
        self.fault_plan = fault_plan
        self._n = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, record: dict):
        rec = dict(record)
        rec["_crc"] = crc32(_canonical(record))
        line = json.dumps(rec)
        torn = (self.fault_plan.torn_write(f"journal/{self._n}")
                if self.fault_plan is not None else None)
        self._n += 1
        if torn is not None:
            line = line[:max(1, int(len(line) * torn))]
        created = not os.path.exists(self.path)
        with open(self.path, "a") as f:
            f.write(line + "\n")
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


def with_retries(fn: Callable, *args, retries: int = 3, backoff: float = 0.0,
                 exceptions=(OSError, IOError), sleep_fn: Callable = None,
                 **kwargs):
    """Bounded retry with exponential backoff (no jitter, no deadlines):
    ``fn`` up to ``retries`` times, sleeping ``backoff * 2^attempt``
    between attempts and never after the last; the terminal
    :class:`~repro_torch.transport.RetryExhaustedError` chains the last
    error.  ``sleep_fn`` replaces :func:`time.sleep` (tests, simulated
    callers).  :meth:`repro_torch.transport.RetryPolicy.call` is the
    jittered policy."""
    from repro_torch.transport.retry import RetryExhaustedError

    sleeper = time.sleep if sleep_fn is None else sleep_fn
    err = None
    for attempt in range(retries):
        try:
            return fn(*args, **kwargs)
        except exceptions as e:
            err = e
            if backoff and attempt < retries - 1:
                sleeper(backoff * (2 ** attempt))
    raise RetryExhaustedError(
        f"{getattr(fn, '__name__', fn)} failed after {retries} attempts: "
        f"{err}", retries) from err


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
