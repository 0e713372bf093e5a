"""Seeded, deterministic fault injection at the transport boundary, as
``repro.transport.faults``.

A :class:`FaultSpec` is the declarative description (frozen; it is the
``faults`` section of an :class:`~repro_torch.experiments.spec
.ExperimentSpec`); a :class:`FaultPlan` is the executable form.  Every
decision is a pure function of ``(seed, key, attempt)`` through a stable
hash (blake2b, never Python's ``hash``, which varies with
``PYTHONHASHSEED``), so one spec replays the same fault sequence across
processes, runs and packages: the draws are the reference's bit for bit.

Fault taxonomy (transfer granularity, decided per attempt):

* **drop** — the frame never arrives; the sender times out and retries.
* **corrupt** — a bit flip somewhere in the frame; the receiver's CRC
  rejects it and the sender retries.
* **duplicate** — the frame arrives twice; wire bytes double for the
  attempt and the receiver's idempotency key absorbs the second copy.
* **latency spike** — delivery succeeds but late (extra seconds).
* **reset** — the connection dies mid-transfer after a deterministic
  fraction of the bytes moved; partial bytes still count as wire bytes.
* **torn write** (storage, not transport) — a journal append or a
  checkpoint array file is cut at a deterministic fraction, exercising
  the CRC and fallback recovery paths in ``runtime/``.

``perma_fail_devices`` lists device ids whose uploads fail every attempt:
the round must complete without them, reweighted, never hung.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple


def stable_hash(*parts) -> int:
    """64-bit hash of the parts, independent of PYTHONHASHSEED."""
    h = hashlib.blake2b("/".join(str(p) for p in parts).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def _unit(*parts) -> float:
    """Deterministic uniform in [0, 1)."""
    return stable_hash(*parts) / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative fault-injection knobs (all probabilities per attempt)."""

    seed: int = 0
    drop_prob: float = 0.0
    corrupt_prob: float = 0.0
    duplicate_prob: float = 0.0
    latency_spike_prob: float = 0.0
    latency_spike_s: float = 1.0
    reset_prob: float = 0.0
    torn_write_prob: float = 0.0
    perma_fail_devices: Tuple[int, ...] = ()

    def validate(self) -> list:
        problems = []
        for f in ("drop_prob", "corrupt_prob", "duplicate_prob",
                  "latency_spike_prob", "reset_prob", "torn_write_prob"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                problems.append(f"faults.{f}={v} outside [0, 1]")
        if self.latency_spike_s < 0:
            problems.append(f"faults.latency_spike_s={self.latency_spike_s}"
                            " negative")
        return problems


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What happens to one delivery attempt."""

    drop: bool = False
    corrupt: bool = False
    duplicate: bool = False
    delay_s: float = 0.0
    reset_frac: Optional[float] = None   # fraction of bytes moved before RST
    bit_index: int = 0                   # which bit to flip when corrupting

    @property
    def delivered(self) -> bool:
        return not (self.drop or self.corrupt or self.reset_frac is not None)


_CLEAN = FaultDecision()


class FaultPlan:
    """Executable fault schedule; ``decide`` is pure and replayable."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._perma = frozenset(spec.perma_fail_devices)

    @property
    def active(self) -> bool:
        s = self.spec
        return bool(self._perma) or any(
            p > 0 for p in (s.drop_prob, s.corrupt_prob, s.duplicate_prob,
                            s.latency_spike_prob, s.reset_prob,
                            s.torn_write_prob))

    def decide(self, key: str, attempt: int = 0,
               device: int = -1) -> FaultDecision:
        """Fate of delivery attempt ``attempt`` of message ``key``;
        ``device`` is the uploading device id, and ids listed in
        ``perma_fail_devices`` drop on every attempt."""
        if device in self._perma:
            return FaultDecision(drop=True)
        s = self.spec
        if not self.active:
            return _CLEAN

        def u(what):
            return _unit(s.seed, key, attempt, what)

        if u("drop") < s.drop_prob:
            return FaultDecision(drop=True)
        if u("reset") < s.reset_prob:
            return FaultDecision(reset_frac=0.05 + 0.9 * u("reset_frac"))
        if u("corrupt") < s.corrupt_prob:
            return FaultDecision(
                corrupt=True,
                bit_index=stable_hash(s.seed, key, attempt, "bit") % (1 << 30))
        delay = (s.latency_spike_s * (0.5 + u("spike_mag"))
                 if u("spike") < s.latency_spike_prob else 0.0)
        dup = u("dup") < s.duplicate_prob
        if delay or dup:
            return FaultDecision(duplicate=dup, delay_s=delay)
        return _CLEAN

    def torn_write(self, key: str) -> Optional[float]:
        """If this storage write should tear, the fraction kept (else
        None)."""
        s = self.spec
        if s.torn_write_prob <= 0:
            return None
        if _unit(s.seed, key, "torn") < s.torn_write_prob:
            return 0.1 + 0.8 * _unit(s.seed, key, "torn_frac")
        return None

    def backoff_jitter(self, key: str, attempt: int) -> float:
        """Deterministic uniform [0, 1) for full-jitter backoff, so retry
        timing (and the accounted simulated time) replays exactly."""
        return _unit(self.spec.seed, key, attempt, "jitter")
