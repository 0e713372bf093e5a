"""Simulated transport, as ``repro.transport.inprocess``.

:class:`InProcessTransport` prices transfers through the link model of
:mod:`repro_torch.core.comm_model` (bytes / bandwidth) without moving any
data.  Without a :class:`~repro_torch.transport.faults.FaultPlan` it is
exactly the analytic accounting: a transfer of N bytes reports N wire
bytes and no extra time, so a fault-free history is the one a run without
a transport gives.

With a fault plan each transfer becomes a bounded retry loop over
deterministic per-attempt fault decisions, and the accounting counts the
bytes actually moved, retries included:

* every attempt's transmitted bytes count (a dropped or corrupted frame
  still crossed the sender's link; a reset moved a deterministic
  fraction; a duplicate doubles the attempt),
* ``extra_time`` is simulated seconds beyond the analytically priced
  first-attempt transmit: retransmissions, full-jitter backoff, drop
  timeouts and latency spikes.  Nothing sleeps.

:func:`cohort_exchange` is one synchronous round's down+up model exchange
over ``transfer`` with the quorum rule: the round proceeds once a quorum
fraction of the cohort has verified uploads, excluding the failed
devices (the trainer reweights over the survivors) instead of stalling.
Nothing here touches a tensor, a generator or the order of cohort draws,
so faults that retries absorb leave a trajectory exactly as it was.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.observability import NULL_OBS
from repro_torch.transport.faults import FaultPlan
from repro_torch.transport.framing import (CorruptFrame, Frame, TruncatedFrame,
                                     decode_frame, encode_frame, flip_bit)
from repro_torch.transport.retry import RetryPolicy

# repro_torch.core.comm_model.BANDWIDTH_BPS (the 50 Mbps testbed link);
# repeated so this module imports without torch
DEFAULT_BANDWIDTH_BPS = 50e6 / 8.0


class QuorumError(RuntimeError):
    """Fewer verified uploads than the quorum requires."""


def required_quorum(n: int, frac: float) -> int:
    """Verified uploads needed for a cohort of ``n`` (at least one)."""
    return max(1, int(math.ceil(frac * n - 1e-9)))


@dataclasses.dataclass(frozen=True)
class TransferResult:
    ok: bool               # delivered with a verified checksum
    wire_bytes: int        # bytes actually moved, all attempts included
    extra_time: float      # sim seconds beyond the first-attempt transmit
    attempts: int
    first_delivery: bool   # False = idempotency key already consumed


def _new_stats() -> Dict[str, float]:
    return {"sends": 0, "delivered": 0, "retries": 0, "drops": 0,
            "corruptions": 0, "duplicates": 0, "resets": 0, "spikes": 0,
            "failures": 0, "wire_bytes": 0, "extra_time": 0.0}


class InProcessTransport:
    """Fault-injecting simulated device-server link."""

    kind = "inprocess"

    def __init__(self, fault_plan: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 default_bandwidth_bps: float = DEFAULT_BANDWIDTH_BPS,
                 obs=None):
        self.fault_plan = fault_plan
        self.retry = retry or RetryPolicy()
        self.default_bandwidth_bps = float(default_bandwidth_bps)
        self.obs = obs if obs is not None else NULL_OBS
        self._delivered: set = set()
        self.stats = _new_stats()
        self._mark = _new_stats()

    @property
    def faulty(self) -> bool:
        return self.fault_plan is not None and self.fault_plan.active

    # ------------------------------------------------------------------
    def delta_stats(self) -> Dict[str, float]:
        """Stats accumulated since the previous call (reset-and-emit).

        The cumulative :attr:`stats` dict is untouched (the experiment
        summary reads it at end of run); only the internal mark moves.
        Zero entries are omitted so per-round log lines stay short.
        """
        delta = {k: self.stats[k] - self._mark[k] for k in self.stats}
        self._mark = dict(self.stats)
        return {k: (round(v, 9) if isinstance(v, float) else v)
                for k, v in delta.items() if v}

    # ------------------------------------------------------------------
    def transfer(self, key: str, nbytes: int, *, device: int = -1,
                 bandwidth_bps: Optional[float] = None,
                 payload: Optional[bytes] = None,
                 phase: Optional[str] = None) -> TransferResult:
        """Move ``nbytes`` from/to ``device`` under the fault plan.

        ``key`` is the message's idempotency key — it must be stable
        across retries *and* across a crash-resumed rerun of the same
        logical step, and unique across distinct messages.  With
        ``payload`` given, an injected corruption is exercised through
        the real CRC framing codec instead of being assumed detected.
        ``phase`` attributes the message's span/metrics to a pipeline
        phase (observability only — never affects accounting).
        """
        obs = self.obs
        if not obs.enabled:
            return self._transfer(key, int(nbytes), device, bandwidth_bps,
                                  payload, None)
        ph = phase or "transport"
        with obs.tracer.span("xfer", track="transport", key=key,
                             device=device, nbytes=int(nbytes),
                             phase=ph) as sp:
            res = self._transfer(key, int(nbytes), device, bandwidth_bps,
                                 payload, sp)
            sp.set(ok=res.ok, attempts=res.attempts,
                   wire_bytes=res.wire_bytes,
                   extra_s=round(res.extra_time, 9),
                   first=res.first_delivery)
        m = obs.metrics
        m.counter("transport_sends", 1, phase=ph)
        m.counter("transport_wire_bytes", res.wire_bytes, phase=ph)
        if res.attempts > 1:
            m.counter("retries", res.attempts - 1, phase=ph)
        if not res.ok:
            m.counter("transport_failures", 1, phase=ph)
        if res.extra_time:
            m.observe("transfer_extra_s", res.extra_time, phase=ph)
        return res

    def _transfer(self, key: str, nbytes: int, device,
                  bandwidth_bps, payload, sp) -> TransferResult:
        self.stats["sends"] += 1
        if not self.faulty:
            first = key not in self._delivered
            self._delivered.add(key)
            self.stats["delivered"] += 1
            self.stats["wire_bytes"] += nbytes
            return TransferResult(True, nbytes, 0.0, 1, first)

        bw = float(bandwidth_bps or self.default_bandwidth_bps)
        plan = self.fault_plan
        wire = 0
        total_t = 0.0
        backoff_t = 0.0
        verdicts = [] if sp is not None else None
        ok = False
        attempt = 0
        for attempt in range(1, self.retry.max_attempts + 1):
            if attempt > 1:
                b = self.retry.backoff_s(
                    attempt - 1, plan.backoff_jitter(key, attempt))
                total_t += b
                backoff_t += b
                self.stats["retries"] += 1
            d = plan.decide(key, attempt, device)
            if d.reset_frac is not None:
                # connection reset mid-transfer: a deterministic fraction
                # crossed the wire before the RST (detected immediately)
                moved = int(nbytes * d.reset_frac)
                wire += moved
                total_t += moved / bw
                self.stats["resets"] += 1
                if verdicts is not None:
                    verdicts.append("reset")
                continue
            if d.drop:
                # the frame left the sender and vanished; the loss is
                # only detected when the ack deadline fires
                wire += nbytes
                total_t += nbytes / bw + self.retry.attempt_timeout_s
                self.stats["drops"] += 1
                if verdicts is not None:
                    verdicts.append("drop")
                continue
            if d.corrupt:
                # arrived, but the receiver's CRC rejects it
                if payload is not None:
                    frame = encode_frame(Frame(
                        kind="data", msg_id=f"{key}#{attempt}",
                        payload=payload, sender=device))
                    try:
                        decode_frame(flip_bit(frame, d.bit_index))
                        raise AssertionError(
                            "bit flip escaped the frame CRC")  # unreachable
                    except (CorruptFrame, TruncatedFrame):
                        pass
                wire += nbytes
                total_t += nbytes / bw
                self.stats["corruptions"] += 1
                if verdicts is not None:
                    verdicts.append("corrupt")
                continue
            # delivered (possibly late, possibly twice)
            mult = 2 if d.duplicate else 1
            wire += mult * nbytes
            total_t += nbytes / bw + d.delay_s
            if d.duplicate:
                self.stats["duplicates"] += 1
            if d.delay_s:
                self.stats["spikes"] += 1
            if verdicts is not None:
                verdicts.append("dup" if d.duplicate else
                                ("spike" if d.delay_s else "delivered"))
            ok = True
            break

        # the first attempt's nominal transmit is already priced by the
        # analytic round time; only the excess is extra
        extra = max(0.0, total_t - nbytes / bw)
        first = False
        if ok:
            first = key not in self._delivered
            self._delivered.add(key)
            self.stats["delivered"] += 1
        else:
            self.stats["failures"] += 1
        self.stats["wire_bytes"] += wire
        self.stats["extra_time"] += extra
        if sp is not None:
            sp.set(verdicts=verdicts, backoff_s=round(backoff_t, 9))
        return TransferResult(ok, wire, extra, attempt, first)


# ---------------------------------------------------------------------------
# quorum-degraded synchronous round exchange
# ---------------------------------------------------------------------------


def cohort_exchange(transport: Optional[InProcessTransport], *,
                    round_key: str, clients, one_way_bytes: int,
                    quorum_frac: float = 1.0, bandwidth_bps=None,
                    phase: Optional[str] = None):
    """One round's per-client down+up model exchange over ``transport``.

    Returns ``(kept_indices, wire_bytes, extra_time, excluded_ids)``.
    ``kept_indices`` index into ``clients``: the devices whose download
    AND checksum-verified upload both succeeded.  Clients transfer in
    parallel, so ``extra_time`` is the worst per-client excess, and a
    client that exhausts its retries is *excluded* (the caller
    reweights over the survivors) rather than stalling the round —
    unless fewer than ``ceil(quorum_frac * len(clients))`` survive, in
    which case :class:`QuorumError` is raised.

    ``transport=None`` (and the fault-free transport) reproduce the
    legacy analytic accounting exactly: all clients kept,
    ``2 * len(clients) * one_way_bytes`` wire bytes, zero extra time.
    ``bandwidth_bps`` may be a scalar or a ``{device_id: bps}`` map.
    ``one_way_bytes`` may be a scalar (every client moves the same
    payload) or a per-client sequence aligned with ``clients`` — a
    heterogeneous-cut fleet exchanges a different device block per cut.
    """
    ids = [int(c) for c in clients]
    try:
        per_client = [int(one_way_bytes)] * len(ids)
    except TypeError:
        per_client = [int(b) for b in one_way_bytes]
        if len(per_client) != len(ids):
            raise ValueError(
                f"one_way_bytes: {len(per_client)} entries for "
                f"{len(ids)} clients")
    if not ids:
        return [], 0, 0.0, []
    if transport is None:
        return list(range(len(ids))), 2 * sum(per_client), 0.0, []
    kept: List[int] = []
    excluded: List[int] = []
    wire = 0
    extra = 0.0
    for i, cid in enumerate(ids):
        bw = (bandwidth_bps.get(cid) if isinstance(bandwidth_bps, dict)
              else bandwidth_bps)
        down = transport.transfer(f"{round_key}/down/{cid}", per_client[i],
                                  device=cid, bandwidth_bps=bw, phase=phase)
        up = transport.transfer(f"{round_key}/up/{cid}", per_client[i],
                                device=cid, bandwidth_bps=bw, phase=phase)
        wire += down.wire_bytes + up.wire_bytes
        extra = max(extra, down.extra_time + up.extra_time)
        if down.ok and up.ok:
            kept.append(i)
        else:
            excluded.append(cid)
            transport.obs.tracer.instant(
                "excluded", track="transport", device=cid,
                round_key=round_key, phase=phase or "transport")
    need = required_quorum(len(ids), quorum_frac)
    if len(kept) < need:
        raise QuorumError(
            f"round {round_key!r}: only {len(kept)}/{len(ids)} verified "
            f"uploads, quorum needs {need} (excluded: {excluded}); raise "
            "transport.max_attempts, lower transport.quorum_frac, or fix "
            "the perma-failed devices")
    return kept, wire, extra, excluded
